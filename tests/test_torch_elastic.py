"""Port vs reference: elastic serving — the slot pool, length buckets, the
admission queue and ``profile_fleet(slots=)``.

Mirrors tests/test_slot_serving.py.  Both packages get the same seeded
numpy inputs (the reference's generators; the port's copies draw the same
numbers).  Estimates are pinned at 1e-5 of their scale
(``max|port - ref| <= 1e-5 * max(1, max|ref|)``: FISTA amplifies last-bit
differences, see ROADMAP "Tolerances"); the rejoin regression at 1e-6, as
the reference pins it.  The reference's zero-retrace gate has no meaning
without a jit cache; its stand-in is checked here on the CPU: a churn trace
moves no engine buffer after ``warmup()``, builds no kernel, and never
reads a tensor on the host in ``step`` / ``admit`` / ``release`` (on the
card ``chip_smoke.py`` runs them under ``torch.cuda.set_sync_debug_mode``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_engine as reng
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.core.profiler import SlotFleetSession as RefPool
from repro.serving.control_plane import ControlConfig as RefControlConfig
from repro.serving.control_plane import ControlLoop as RefControlLoop
from repro.serving.control_plane import EnergyFirstControlPlane as RefControlPlane
from repro.serving.scheduler import SlotAdmissionQueue as RefQueue
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.telemetry.simulator import churn_schedule as ref_churn_schedule
from repro.workload.azure import WorkloadConfig as RefWorkloadConfig
from repro.workload.azure import generate_trace as ref_generate_trace
from repro.workload.functions import paper_functions as ref_paper_functions
from repro_torch.core import engine as te
from repro_torch.core.profiler import ProfilerConfig
from repro_torch.core.sessions import SlotFleetSession
from repro_torch.kernels import build
from repro_torch.serving import ControlConfig, ControlLoop, EnergyFirstControlPlane
from repro_torch.serving.scheduler import SlotAdmissionQueue
from repro_torch.telemetry.simulator import SimulatorConfig, churn_schedule
from repro_torch.workload.azure import WorkloadConfig, generate_trace
from repro_torch.workload.functions import paper_functions

CFG = te.EngineConfig()
REF_CFG = reng.EngineConfig()
CPU = dict(device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled(port, ref, rel=1e-5) -> bool:
    port, ref = np.asarray(_np(port), np.float64), np.asarray(_np(ref), np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref), initial=0.0)) <= rel * max(1.0, float(np.abs(ref).max(initial=0.0)))


def _stack(est, nodes):
    return np.stack([est[n] for n in nodes])


def _feed_rows(inputs, t, nodes):
    """numpy per-node rows of tick ``t`` of the reference's tick stream."""
    row = jax.tree.map(lambda l: np.asarray(l[t]), reng.fleet_ticks(inputs))
    return {n: (row.c[n], row.w[n], row.a[n], row.lat_sum[n], row.lat_sumsq[n]) for n in nodes}


def _rand_feed(rng, m):
    return (
        rng.random(m).astype(np.float32),
        np.float32(40.0 + 10.0 * rng.random()),
        rng.integers(0, 2, m).astype(np.float32),
        rng.random(m).astype(np.float32),
        rng.random(m).astype(np.float32),
    )


def _ref_fleet(b, s, n_w, m, seed):
    """The reference's synthetic fleet and the port's copy of the same arrays."""
    ref = reng.synthetic_fleet(b, s, n_w, m, seed=seed)
    return ref, te.synthetic_fleet(b, s, n_w, m, seed=seed, **CPU)


# ---------------------------------------------------------------------------
# Static fleet: pool == segment engines (spare slots included).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["run_fleet", "run_fleet_gram", "run_fleet_stream"])
def test_static_pool_matches_engines(name):
    """A static fleet driven through the port's pool (2 spare slots) gives
    the reference engine's x_final, and the port engine's, at 1e-5 of
    scale; the spares stay free."""
    b, s, n_w, m = 3, 4, 6, 8
    ref_in, port_in = _ref_fleet(b, s, n_w, m, seed=0)
    want = getattr(reng, name)(ref_in, REF_CFG)
    mine = getattr(te, name)(port_in, CFG, **CPU)
    pool = SlotFleetSession(b + 2, m, step_windows=n_w, config=CFG, **CPU)
    pool.warmup()
    for i in range(b):
        pool.admit(i, x0=mine.x0[i])
    for t in range(s * n_w):
        pool.step(_feed_rows(ref_in, t, range(b)))
    got = _stack(pool.estimates(), range(b))
    assert _scaled(got, want.x_final)
    assert _scaled(got, mine.x_final)
    assert pool.free_slots == 2 and pool.ticks == s * n_w


@pytest.mark.parametrize("k", [1, 2, 4])
def test_static_pool_sharded(k):
    """The same pin with the pool state split over a k-entry mesh of the
    CPU (capacity 8 tiles 1, 2 and 4)."""
    from repro_torch.distributed import Shards, fleet_mesh

    b, s, n_w, m = 6, 3, 5, 4
    ref_in, port_in = _ref_fleet(b, s, n_w, m, seed=1)
    want = reng.run_fleet(ref_in, REF_CFG)
    x0 = te.run_fleet(port_in, CFG, **CPU).x0
    pool = SlotFleetSession(8, m, step_windows=n_w, config=CFG, mesh=fleet_mesh(devices=["cpu"] * k))
    ptrs = pool.warmup()
    assert isinstance(pool.state, Shards) and len(pool.state) == k
    assert len(ptrs) == 11 * k  # every shard's buffers are covered
    for i in range(b):
        pool.admit(i, x0=x0[i])
    for t in range(s * n_w):
        pool.step(_feed_rows(ref_in, t, range(b)))
    assert _scaled(_stack(pool.estimates(), range(b)), want.x_final)
    assert pool.buffer_pointers() == ptrs


# ---------------------------------------------------------------------------
# Churn: the stand-in for zero retraces; node independence; rejoin.
# ---------------------------------------------------------------------------


def _churn_events(cap, m, horizon, seed):
    spans = churn_schedule(16, horizon, capacity=cap, seed=seed, mean_lifetime=22.0, mean_gap=3.0)
    ref_spans = ref_churn_schedule(16, horizon, capacity=cap, seed=seed, mean_lifetime=22.0, mean_gap=3.0)
    assert [tuple(s) for s in spans] == [tuple(s) for s in ref_spans]
    joins, leaves = {}, {}
    for sp in spans:
        joins.setdefault(sp.join, []).append(sp.node)
        leaves.setdefault(sp.leave, []).append(sp.node)
    return spans, joins, leaves


def test_churn_keeps_buffers_and_reads_nothing(monkeypatch):
    """Joins, leaves, dropped windows and bucketed init solves of assorted
    lengths: after ``warmup()`` no engine buffer moves, no kernel source is
    built, and ``step``/``admit``/``release`` never read a tensor on the
    host; the final estimates equal the reference pool's fed the same
    trace at 1e-5 of scale."""
    cap, m, n_w, horizon = 6, 4, 5, 80
    spans, joins, leaves = _churn_events(cap, m, horizon, seed=3)
    rng = np.random.default_rng(0)
    events = []
    live: set = set()
    for t in range(horizon):
        gone = list(leaves.get(t, ()))
        live -= set(gone)
        came = [(n, int(rng.integers(3, 20))) for n in joins.get(t, ())]
        blocks = {
            n: (rng.random((k, m)).astype(np.float32), rng.random(k).astype(np.float32) * 30.0)
            for n, k in came
        }
        live |= set(blocks)
        feeds = {n: _rand_feed(rng, m) for n in sorted(live) if rng.random() > 0.1}
        events.append((gone, blocks, feeds))

    def drive(pool):
        for gone, blocks, feeds in events:
            for n in gone:
                pool.release(n)
            for n, (c, w) in blocks.items():
                pool.admit(n, c, w)
            pool.step({n: feeds[n] for n in pool.live_nodes if n in feeds})

    ref_pool = RefPool(cap, m, step_windows=n_w, config=REF_CFG)
    ref_pool.warmup()
    drive(ref_pool)

    pool = SlotFleetSession(cap, m, step_windows=n_w, config=CFG, **CPU)
    ptrs = pool.warmup()
    built = len(build.built)
    armed = {"on": False}

    def guard(name, orig):
        def guarded(self, *args, **kwargs):
            if armed["on"]:
                raise AssertionError(f"the pool read a tensor on the host ({name})")
            return orig(self, *args, **kwargs)
        return guarded

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    armed["on"] = True
    try:
        drive(pool)
    finally:
        armed["on"] = False
    assert pool.admits == ref_pool.admits == len(spans)
    assert pool.releases == ref_pool.releases and pool.ticks == horizon
    assert pool.buffer_pointers() == ptrs
    assert len(build.built) == built
    got, want = pool.estimates(), ref_pool.estimates()
    assert set(got) == set(want) and pool.live_nodes == ref_pool.live_nodes
    nodes = sorted(want)
    assert _scaled(_stack(got, nodes), _stack(want, nodes))


def test_join_mid_stream_is_node_independent():
    """A node joining a busy pool at a step boundary ends with the estimate
    a one-slot pool fed only its own ticks gives, and with the reference's."""
    m, n_w = 4, 5
    rng = np.random.default_rng(7)
    x0 = rng.random(m).astype(np.float32) * 5.0
    late = [_rand_feed(rng, m) for _ in range(3 * n_w)]
    x0_bg = [rng.random(m).astype(np.float32) for _ in range(2)]
    bg = np.random.default_rng(11)
    early = [{n: _rand_feed(bg, m) for n in (0, 1)} for _ in range(2 * n_w)]
    during = [{n: _rand_feed(bg, m) for n in (0, 1)} for _ in range(3 * n_w)]

    def busy(cls, **kw):
        pool = cls(3, m, step_windows=n_w, **kw)
        pool.warmup()
        pool.admit(0, x0=x0_bg[0])
        pool.admit(1, x0=x0_bg[1])
        for feeds in early:
            pool.step(feeds)
        pool.admit(9, x0=x0)
        for t, feeds in enumerate(during):
            pool.step({**feeds, 9: late[t]})
        return pool.estimates()[9]

    solo = SlotFleetSession(1, m, step_windows=n_w, config=CFG, **CPU)
    solo.warmup()
    solo.admit(9, x0=x0)
    for t in range(3 * n_w):
        solo.step({9: late[t]})
    got = busy(SlotFleetSession, config=CFG, **CPU)
    assert _scaled(got, solo.estimates()[9])
    assert _scaled(got, busy(RefPool, config=REF_CFG))


def test_rejoin_resets_partial_step_rows():
    """A tenant admitted into a slot whose previous occupant wrote ticks
    earlier in the current partial step sees a clean ring buffer: the same
    estimate as joining a never-occupied slot (1e-6)."""
    m, n_w = 3, 5
    rng = np.random.default_rng(5)
    x0_b = rng.random(m).astype(np.float32)
    b_feeds = [_rand_feed(rng, m) for _ in range(2 * n_w)]

    def run(with_previous_tenant):
        pool = SlotFleetSession(1, m, step_windows=n_w, config=CFG, **CPU)
        pool.warmup()
        junk = np.random.default_rng(1)
        if with_previous_tenant:
            pool.admit(0, x0=junk.random(m).astype(np.float32) * 9.0)
        for _ in range(2):  # two ticks into a 5-tick step
            pool.step({0: _rand_feed(junk, m)} if with_previous_tenant else {})
        if with_previous_tenant:
            pool.release(0)
        pool.admit(7, x0=x0_b)
        for t in range(2 * n_w):
            pool.step({7: b_feeds[t]})
        return pool.estimates()[7]

    np.testing.assert_allclose(run(True), run(False), rtol=1e-6, atol=1e-6)


def test_pool_refusals():
    pool = SlotFleetSession(1, 2, step_windows=3, config=CFG, **CPU)
    pool.admit(0, x0=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="already holds"):
        pool.admit(0, x0=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="pool full"):
        pool.admit(1, x0=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="holds no slot"):
        pool.step({5: _rand_feed(np.random.default_rng(0), 2)})
    with pytest.raises(ValueError, match="x0= or an"):
        SlotFleetSession(1, 2, step_windows=3, **CPU).admit(3)
    assert pool.release(0) == 0 and pool.free_slots == 1
    with pytest.raises(ValueError, match="holds no slot"):
        pool.release(0)


# ---------------------------------------------------------------------------
# Length buckets: init solves and packing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8, 9, 16, 100, 512, 513, 5000])
def test_bucket_for_table(n):
    assert te.bucket_for(n) == reng.bucket_for(n)
    assert te.bucket_for(n, (2, 4)) == reng.bucket_for(n, (2, 4))
    assert te.DEFAULT_BUCKETS == reng.DEFAULT_BUCKETS


def test_bucket_for_refuses_empty():
    with pytest.raises(ValueError):
        te.bucket_for(0)


@pytest.mark.parametrize("n", [5, 13, 64])
def test_bucketed_init_matches_exact(n):
    """Zero-padding an init block to its bucket is exact in the gram
    domain: the bucketed solve equals the unpadded one and the reference's
    bucketed solve at 1e-5 of scale."""
    rng = np.random.default_rng(2 + n)
    c = rng.random((n, 6)).astype(np.float32)
    w = (rng.random(n) * 40.0).astype(np.float32)
    got = te.bucketed_initial_estimate(c, w, CFG, **CPU)
    exact = te.fleet_initial_estimate(torch.from_numpy(c)[None], torch.from_numpy(w)[None], CFG)[0]
    assert _scaled(got, exact)
    assert _scaled(got, reng.bucketed_initial_estimate(jnp.asarray(c), jnp.asarray(w), REF_CFG))


def test_warm_bucket_solvers_counts():
    assert te.warm_bucket_solvers(3, CFG, buckets=(2, 4), **CPU) == 2


def test_synthetic_ragged_windows_matches_reference():
    lengths = [5, 9, 40, 1]
    got = te.synthetic_ragged_windows(4, 40, 5, lengths=lengths, seed=4, **CPU)
    want = reng.synthetic_ragged_windows(4, 40, 5, lengths=lengths, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("engine", ["run_fleet", "run_fleet_gram", "run_fleet_stream"])
def test_pack_fleet_buckets_matches_monolithic(engine):
    """Extreme rag: the bucketed groups reproduce the monolithic pack per
    node (1e-5 of scale), and the reference's bucketed run, while wasting
    far fewer padded ticks; the groups and the waste are the reference's."""
    n_w = 4
    lengths = [5, 9, 96, 8, 13, 17]
    b, n, m = len(lengths), max(lengths), 5
    arrs = te.synthetic_ragged_windows(b, n, m, lengths=lengths, seed=4, **CPU)
    ref_arrs = reng.synthetic_ragged_windows(b, n, m, lengths=lengths, seed=4)
    kw = dict(step_windows=n_w, lengths=lengths, buckets=(2, 4, 8, 16, 32))
    mono = te.run_fleet(te.pack_fleet_inputs(*arrs, step_windows=n_w, lengths=lengths, **CPU), CFG, **CPU)
    buckets = te.pack_fleet_buckets(*arrs, **kw, **CPU)
    ref_buckets = reng.pack_fleet_buckets(*ref_arrs, **kw)
    assert [(bk.nodes, bk.lengths, bk.steps) for bk in buckets] == [
        (bk.nodes, bk.lengths, bk.steps) for bk in ref_buckets
    ]
    assert len(buckets) > 1
    x_final, x0, results = te.run_fleet_bucketed(buckets, CFG, engine=getattr(te, engine))
    ref_x, ref_x0, _ = reng.run_fleet_bucketed(ref_buckets, REF_CFG, engine=getattr(reng, engine))
    assert len(results) == len(buckets)
    assert _scaled(x_final, mono.x_final) and _scaled(x0, mono.x0)
    assert _scaled(x_final, ref_x) and _scaled(x0, ref_x0)
    waste_mono = te.pad_waste_frac(lengths, n_w)
    waste_bkt = te.bucketed_pad_waste(buckets, n_w)
    assert waste_mono == reng.pad_waste_frac(lengths, n_w)
    assert waste_bkt == reng.bucketed_pad_waste(ref_buckets, n_w)
    assert waste_bkt < waste_mono and waste_mono > 0.5


def test_pad_steps_masks_the_padding():
    """A block padded to its bucket carries fully masked zero steps."""
    inputs = te.synthetic_fleet(2, 3, 4, 3, seed=0, **CPU)
    padded = te.buckets._pad_steps(inputs, 5)
    assert padded.c.shape == (2, 5, 4, 3) and padded.mask.shape == (2, 5, 4)
    assert torch.equal(padded.mask[:, :3], torch.ones(2, 3, 4))
    assert not padded.mask[:, 3:].any() and not padded.c[:, 3:].any()


# ---------------------------------------------------------------------------
# Mesh elasticity: mid-stream reshard.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_reshard_mid_stream_pinned(k):
    """checkpoint -> place -> resume (unsharded -> a k-entry mesh ->
    unsharded) equals the uninterrupted run at 1e-5 of scale, and the
    reference's uninterrupted pool."""
    from repro_torch.distributed import Shards, fleet_mesh

    cap, m, n_w = 4, 3, 5

    def build_pool(cls, **kw):
        pool = cls(cap, m, step_windows=n_w, **kw)
        pool.warmup()
        for i in range(cap):
            pool.admit(i, x0=np.full(m, 0.5 * (i + 1), np.float32))
        return pool

    def drive(pool, ticks, rng):
        for _ in range(ticks):
            pool.step({n: _rand_feed(rng, m) for n in range(cap)})

    a = build_pool(SlotFleetSession, config=CFG, **CPU)
    drive(a, 23, np.random.default_rng(1))
    ref = build_pool(RefPool, config=REF_CFG)
    drive(ref, 23, np.random.default_rng(1))
    b = build_pool(SlotFleetSession, config=CFG, **CPU)
    rng = np.random.default_rng(1)
    drive(b, 11, rng)
    b.reshard(fleet_mesh(cap, devices=["cpu"] * k))
    assert isinstance(b.state, Shards) and len(b.state) == k
    drive(b, 12, rng)
    b.reshard(None)
    assert not isinstance(b.state, Shards) and b.mesh is None
    nodes = range(cap)
    assert _scaled(_stack(b.estimates(), nodes), _stack(a.estimates(), nodes))
    assert _scaled(_stack(b.estimates(), nodes), _stack(ref.estimates(), nodes))


# ---------------------------------------------------------------------------
# Admission queue.
# ---------------------------------------------------------------------------


def _queue_trace(pool_cls, queue_cls, **kw):
    m, n_w = 3, 4
    pool = pool_cls(2, m, step_windows=n_w, **kw)
    pool.warmup()
    q = queue_cls(pool)
    out = [q.submit(0, x0=np.zeros(m, np.float32)), q.submit(1, x0=np.zeros(m, np.float32))]
    out += [q.submit(2, x0=np.zeros(m, np.float32)), q.submit(3, x0=np.zeros(m, np.float32)), q.pending]
    pool.release(0)
    out += [q.drain(), q.pending]
    pool.release(1)
    out += [q.drain(), q.pending]
    # A gated head request parks the whole queue (head-of-line blocking).
    open_gate = [False]
    gated = queue_cls(pool, gate=lambda req: open_gate[0])
    pool.release(2)
    out += [gated.submit(9, x0=np.zeros(m, np.float32)), gated.pending, gated.deferred]
    open_gate[0] = True
    out += [gated.drain(), gated.admitted, q.admitted]
    return out


def test_admission_queue_fifo_and_gate():
    got = _queue_trace(SlotFleetSession, SlotAdmissionQueue, config=CFG, **CPU)
    assert got == _queue_trace(RefPool, RefQueue, config=REF_CFG)
    assert got[:5] == [0, 1, None, None, 2]
    assert got[5:9] == [[(2, 0)], 1, [(3, 1)], 0]
    assert got[9:12] == [None, 1, 1] and got[12] == [(9, 0)]


def test_admission_queue_bucketed_init_block():
    """A queued join carrying an init block is solved at admission."""
    rng = np.random.default_rng(3)
    c, w = rng.random((11, 3)).astype(np.float32), (rng.random(11) * 20).astype(np.float32)
    pool = SlotFleetSession(1, 3, step_windows=4, config=CFG, **CPU)
    q = SlotAdmissionQueue(pool)
    assert q.submit(0, x0=np.ones(3, np.float32)) == 0
    assert q.submit(1, c, w) is None
    pool.release(0)
    assert q.drain() == [(1, 0)]
    assert _scaled(pool.estimates()[1], te.bucketed_initial_estimate(c, w, CFG, **CPU))


# ---------------------------------------------------------------------------
# Control plane: profile_fleet(slots=...) and ControlLoop under churn.
# ---------------------------------------------------------------------------

_PCFG = dict(init_windows=40, step_windows=20)


def _plane(ref: bool):
    if ref:
        return RefControlPlane(ref_paper_functions(), RefSimConfig(platform="edge"), RefProfilerConfig(**_PCFG))
    return EnergyFirstControlPlane(
        paper_functions(), SimulatorConfig(platform="edge"), ProfilerConfig(**_PCFG), device="cpu"
    )


def _traces(ref: bool, durations, load=1.0):
    gen, cfg, reg = (
        (ref_generate_trace, RefWorkloadConfig, ref_paper_functions)
        if ref
        else (generate_trace, WorkloadConfig, paper_functions)
    )
    registry = reg()
    return [gen(registry, cfg(duration_s=d, load=load, seed=i)) for i, d in enumerate(durations)]


def test_profile_fleet_slots_matches_plain():
    """A ragged fleet through a 6-slot pool equals the plain session and the
    reference's pool at 1e-5 of scale; every live tick is conserved."""
    durations = (100.0, 140.0, 120.0)
    seen = []

    def hook(tick, trackers):
        seen.append(tick.t)
        live = np.ones(3, bool) if tick.valid is None else tick.valid
        recon = tick.tick_power.sum(-1) + tick.unattributed
        np.testing.assert_allclose(recon[live], tick.target[live], atol=1e-3)
        assert not recon[~live].any()  # an ended node attributes exactly 0

    plain = _plane(False).profile_fleet(_traces(False, durations), mesh=None)
    slot = _plane(False).profile_fleet(_traces(False, durations), mesh=None, slots=6, on_tick=hook)
    ref = _plane(True).profile_fleet(_traces(True, durations), mesh=None, slots=6)
    assert seen == list(range(40, 140))
    for a, b, r in zip(plain, slot, ref):
        for name in ("x_power", "x_trajectory"):
            assert _scaled(getattr(b.report, name), getattr(a.report, name)), name
            assert _scaled(getattr(b.report, name), getattr(r.report, name)), name
        assert b.footprint_stream.ticks_seen == a.footprint_stream.ticks_seen
        assert _scaled(b.footprint_stream.j_indiv, r.footprint_stream.j_indiv)


def test_profile_fleet_slots_combined_matches_plain():
    """Combined mode (§4.3) through the pool: the pool tick carries the
    chip-subtracted target, so reports equal the unpooled session's."""
    durations = (160.0, 200.0)
    plane = EnergyFirstControlPlane(
        paper_functions(), SimulatorConfig(platform="server"), ProfilerConfig(**_PCFG), device="cpu"
    )
    plain = plane.profile_fleet(_traces(False, durations), mode="combined")
    slot = plane.profile_fleet(_traces(False, durations), mode="combined", slots=3)
    for a, b in zip(plain, slot):
        for name in ("x_power", "x_trajectory"):
            assert _scaled(getattr(b.report, name), getattr(a.report, name)), name
        assert b.report.total_error == pytest.approx(a.report.total_error, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("kw", [dict(prefetch=0), dict(drain=True)])
def test_profile_fleet_slots_ingest_modes_bitwise(kw):
    """The pool tick runs in the dispatch stage, so strict alternation and
    the drain thread give the inline prefetched run's bits."""
    durations = (100.0, 140.0, 120.0)
    base = _plane(False).profile_fleet(_traces(False, durations), mesh=None, slots=4)
    other = _plane(False).profile_fleet(_traces(False, durations), mesh=None, slots=4, **kw)
    for a, b in zip(base, other):
        assert torch.equal(a.report.x_trajectory, b.report.x_trajectory)
        np.testing.assert_array_equal(a.footprint_stream.j_indiv, b.footprint_stream.j_indiv)


def test_profile_fleet_slots_too_small_raises():
    with pytest.raises(ValueError, match="slots"):
        _plane(False).profile_fleet(_traces(False, (160.0,) * 3), mesh=None, slots=2)


def test_control_loop_survives_churn():
    """A ControlLoop bound to a slot-pool replay of a ragged fleet (nodes
    leaving mid-segment) finishes and reshapes every node's trace, as the
    reference's does; placement moves work between nodes (each node ends
    with the reference's count), and the fleet's invocations are
    conserved."""
    durations = (120.0, 160.0, 140.0)
    loop = ControlLoop(ControlConfig(cap_watts=250.0))
    out = _plane(False).profile_fleet(_traces(False, durations, 2.0), mesh=None, slots=5, control=loop)
    ref_loop = RefControlLoop(RefControlConfig(cap_watts=250.0))
    _plane(True).profile_fleet(_traces(True, durations, 2.0), mesh=None, slots=5, control=ref_loop)
    controlled, ref_controlled = loop.controlled_traces(), ref_loop.controlled_traces()
    assert len(out) == len(controlled) == len(ref_controlled) == 3
    total = sum(tr.num_invocations for tr in _traces(False, durations, 2.0))
    assert sum(p.num_invocations for p in controlled) == total
    assert sum(r.num_invocations for r in ref_controlled) == total
    # The loop's placements follow the reference's node for node.
    assert [p.num_invocations for p in controlled] == [r.num_invocations for r in ref_controlled]
