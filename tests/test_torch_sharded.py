"""Port vs reference: the node-axis ``FleetMesh`` (sharded fleet engines).

Mirrors tests/test_sharded_fleet.py and the sharded cases of
tests/test_ragged_fleet.py.  The reference's multi-device cases need
several JAX devices and skip here; the port's mesh may repeat a device, so
its k-shard runs (``fleet_mesh(devices=["cpu"] * k)``, k = 1, 2, 4) execute
the split, per-shard dispatch, join and totals on this CPU and are held
against the reference's *unsharded* run: 1e-5 of scale for estimates
(``max|port - ref| <= 1e-5 * max(1, max|ref|)``), per-tick power at 1e-5 of
its scale, totals at rtol 1e-5.  The one-device mesh is pinned bit for bit
to mesh=None, as the port promises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_engine as reng
from repro.core.profiler import FaasMeterProfiler as RefProfiler
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.core.profiler import fleet_profile_batched as ref_fleet_profile_batched
from repro.distributed.sharding import fleet_attribution_totals as ref_totals
from repro.serving.control_plane import EnergyFirstControlPlane as RefControlPlane
from repro.telemetry.simulator import NodeSimulator as RefSimulator
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.workload.azure import WorkloadConfig as RefWorkloadConfig
from repro.workload.azure import generate_trace as ref_generate_trace
from repro.workload.functions import paper_functions as ref_paper_functions
from repro_torch.convert import telemetry_from_numpy
from repro_torch.core import engine as te
from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
from repro_torch.distributed import (
    FleetMesh,
    Shards,
    fleet_attribution_totals,
    fleet_mesh,
    fleet_mesh_auto,
    reshard,
)
from repro_torch.serving import EnergyFirstControlPlane
from repro_torch.telemetry.simulator import SimulatorConfig
from repro_torch.workload.azure import WorkloadConfig, generate_trace
from repro_torch.workload.functions import paper_functions

ENGINES = ["run_fleet", "run_fleet_gram", "run_fleet_stream"]
FIELDS = ("x_final", "x_trajectory", "x0", "tick_power", "unattributed")
CFG = te.EngineConfig()
REF_CFG = reng.EngineConfig()


def _mesh(k: int) -> FleetMesh:
    return fleet_mesh(devices=["cpu"] * k)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled(port, ref, rel=1e-5) -> bool:
    port, ref = np.asarray(_np(port), np.float64), np.asarray(_np(ref), np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref), initial=0.0)) <= rel * max(1.0, float(np.abs(ref).max(initial=0.0)))


def _assert_result_close(out, ref):
    for name in FIELDS:
        assert _scaled(getattr(out, name), getattr(ref, name)), name


def _fleets(b, s, n_w, m, seed, density=0.2):
    ref = reng.synthetic_fleet(b, s, n_w, m, seed=seed, density=density)
    return ref, te.synthetic_fleet(b, s, n_w, m, seed=seed, density=density, device="cpu")


# ---------------------------------------------------------------------------
# Mesh construction / validation / placement.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 3, 5, 6, 7, 8, 12])
def test_fleet_mesh_fits_largest_divisor(b):
    """fleet_mesh(num_nodes) never builds a mesh the fleet cannot tile, and
    uses the most devices that tile it."""
    fm = fleet_mesh(b, devices=["cpu"] * 8)
    assert b % fm.num_devices == 0 and fm.num_devices <= 8
    assert all(b % d for d in range(fm.num_devices + 1, 9))
    assert fleet_mesh(devices=["cpu"] * 8).num_devices == 8


def test_fleet_mesh_default_devices_are_the_cards():
    if torch.cuda.is_available():
        assert fleet_mesh().num_devices == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_mesh()


def test_fleet_mesh_auto_single_device_is_none():
    """One visible card (or none): the control plane keeps the unsharded
    path, as the reference does on one JAX device."""
    if torch.cuda.device_count() > 1:
        pytest.skip("single-device semantics")
    assert fleet_mesh_auto(4) is None and fleet_mesh_auto(64) is None


def test_mesh_is_frozen_and_hashable():
    fm = _mesh(2)
    assert fm == _mesh(2) and hash(fm) == hash(_mesh(2)) and fm != _mesh(4)
    assert fm.devices == (torch.device("cpu"),) * 2 and fm.axis == "node"
    with pytest.raises(Exception):
        fm.axis = "x"


def test_mesh_put_splits_nodes_and_replicates_scalars():
    fm = _mesh(2)
    x0 = te.fleet_initial_estimate(*te.synthetic_fleet(4, 2, 6, 3, seed=1, device="cpu")[:2], CFG)
    state = te.fleet_stream_init(x0, 6, device="cpu")
    placed = fm.put(state)
    assert isinstance(placed, Shards) and len(placed) == 2
    assert placed[0].c_buf.shape == (2, 6, 3) and placed[1].kalman.x.shape == (2, 3)
    assert placed[0].tick_in_step == placed[1].tick_in_step == 0
    torch.testing.assert_close(fm.join(placed).kalman.x, x0, rtol=0, atol=0)
    specs = fm.specs_like(state)
    assert specs.c_buf == "node" and specs.kalman.p == "node" and specs.tick_in_step is None
    assert fm.specs_like(torch.zeros(())) is None


def test_validate_rejects_untiled_fleet():
    fm = _mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        fm.validate(3)
    with pytest.raises(ValueError, match="not divisible"):
        te.run_fleet(te.synthetic_fleet(3, 2, 6, 4, seed=0, device="cpu"), CFG, mesh=fm)
    with pytest.raises(ValueError, match="not divisible"):
        te.fleet_stream_init(torch.zeros(3, 4), 6, mesh=fm)


def test_sharded_step_needs_sharded_state():
    fm = _mesh(2)
    state = te.fleet_stream_init(torch.zeros(4, 3), 5, device="cpu")
    tick = te.fleet_ticks(te.synthetic_fleet(4, 1, 5, 3, seed=0, device="cpu")).at(0)
    with pytest.raises(ValueError, match="one state per device"):
        te.fleet_step(state, tick, CFG, mesh=fm)


# ---------------------------------------------------------------------------
# The one-device mesh is the identity: bit for bit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENGINES)
def test_one_device_mesh_is_bitwise_identity(name):
    fn = getattr(te, name)
    _, inputs = _fleets(3, 2, 8, 5, seed=0)
    out, ref = fn(inputs, CFG, mesh=_mesh(1)), fn(inputs, CFG, device="cpu")
    for field in FIELDS:
        assert torch.equal(getattr(out, field), getattr(ref, field)), field
    for a, b in zip(out.state, ref.state):
        assert torch.equal(a, b)


def test_one_device_mesh_stream_is_bitwise_identity():
    _, inputs = _fleets(3, 2, 8, 5, seed=4)
    x0 = te.fleet_initial_estimate(inputs.c, inputs.w, CFG)
    ticks = te.fleet_ticks(inputs)
    plain = te.fleet_stream_init(x0, 8, device="cpu")
    meshed = te.fleet_stream_init(x0, 8, mesh=_mesh(1))
    for t in range(16):
        plain, a = te.fleet_step(plain, ticks.at(t), CFG)
        meshed, b = te.fleet_step(meshed, ticks.at(t), CFG, mesh=_mesh(1))
        for field in ("tick_power", "unattributed", "x"):
            assert torch.equal(getattr(a, field), getattr(b, field)), (t, field)
        assert a.step_completed == b.step_completed
    assert meshed[0].step_idx == plain.step_idx == 2


# ---------------------------------------------------------------------------
# Equivalence: k-shard port == the reference's unsharded engines.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", ENGINES)
def test_sharded_engine_matches_unsharded(name, k):
    ref_in, inputs = _fleets(8, 3, 12, 10, seed=k)
    out = getattr(te, name)(inputs, CFG, mesh=_mesh(k))
    _assert_result_close(out, getattr(reng, name)(ref_in, REF_CFG))
    _assert_result_close(out, getattr(te, name)(inputs, CFG, device="cpu"))
    assert out.x_final.shape == (8, 10) and out.state.x.shape == (8, 10)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_respects_dedicated_init_block(k):
    """The profiler-style init_c/init_w path shards too, and so does the
    mixed case, whose missing default is the *masked* inputs."""
    ref_in, inputs = _fleets(4, 3, 10, 6, seed=9)
    ref_init, init = _fleets(4, 1, 25, 6, seed=10)
    kw = dict(init_c=init.c.reshape(4, 25, 6), init_w=init.w.reshape(4, 25))
    ref_kw = dict(init_c=ref_init.c.reshape(4, 25, 6), init_w=ref_init.w.reshape(4, 25))
    _assert_result_close(
        te.run_fleet(inputs, CFG, mesh=_mesh(k), **kw), reng.run_fleet(ref_in, REF_CFG, **ref_kw)
    )
    mixed = dict(init_c=inputs.c * 0.5)  # init_w defaults to the masked inputs
    _assert_result_close(
        te.run_fleet_gram(inputs, CFG, mesh=_mesh(k), **mixed),
        reng.run_fleet_gram(ref_in, REF_CFG, init_c=ref_in.c * 0.5),
    )


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_stream_tick_at_a_time(k):
    """Driving the sharded step tick by tick equals the reference's stream
    at 1e-5 of scale; the state stays split, in place, for the whole
    stream."""
    b, s, n_w, m = 8, 3, 8, 6
    ref_in, inputs = _fleets(b, s, n_w, m, seed=3)
    ref = reng.run_fleet_stream(ref_in, REF_CFG)
    fm = _mesh(k)
    x0 = te.fleet_initial_estimate(inputs.c, inputs.w, CFG)
    state = te.fleet_stream_init(x0, n_w, mesh=fm)
    ptrs = [s_.c_buf.data_ptr() for s_ in state]
    ticks = te.fleet_ticks(inputs)
    boundary = []
    for t in range(s * n_w):
        state, att = te.fleet_step(state, ticks.at(t), CFG, mesh=fm)
        assert att.x.shape == (b, m)
        if att.step_completed:
            boundary.append(att.x)
    assert isinstance(state, Shards) and len(state) == k
    assert [s_.c_buf.data_ptr() for s_ in state] == ptrs
    assert all(s_.step_idx == s for s_ in state)
    assert _scaled(fm.join([s_.kalman.x for s_ in state]), ref.x_final)
    assert _scaled(torch.stack(boundary, dim=1), ref.x_trajectory)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_stream_conserves_per_tick(k):
    """attributed + unattributed == measured on every tick, every shard."""
    b, s, n_w, m = 4, 2, 6, 5
    _, inputs = _fleets(b, s, n_w, m, seed=11, density=0.3)
    fm = fleet_mesh(b, devices=["cpu"] * k)
    x0 = te.fleet_initial_estimate(inputs.c, inputs.w, CFG)
    state = te.fleet_stream_init(x0, n_w, mesh=fm)
    ticks = te.fleet_ticks(inputs)
    for t in range(s * n_w):
        tick = ticks.at(t)
        state, att = te.fleet_step(state, tick, CFG, mesh=fm)
        recon = att.tick_power.sum(-1) + att.unattributed
        np.testing.assert_allclose(recon.numpy(), tick.w.numpy(), atol=1e-3)


def test_sharded_slot_reset_rewrites_only_flagged_rows():
    fm = _mesh(2)
    state = te.fleet_stream_init(torch.ones(4, 3), 5, mesh=fm)
    flags = torch.tensor([0.0, 0.0, 1.0, 0.0])
    state = te.fleet_stream_reset_slots(state, flags, torch.full((4, 3), 7.0), mesh=fm)
    x = fm.join([s_.kalman.x for s_ in state])
    assert torch.equal(x, torch.tensor([[1.0] * 3, [1.0] * 3, [7.0] * 3, [1.0] * 3]))


# ---------------------------------------------------------------------------
# Ragged fleets shard like dense ones.
# ---------------------------------------------------------------------------

N_W = 8
N = 5 * N_W
LENGTHS = [N, 3 * N_W + 3, N_W, 5, N // 2, N - 1, 2 * N_W, N]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", ENGINES)
def test_ragged_sharded_matches_unsharded(name, k):
    """The mask splits with the node axis; the 1e-5 pin holds against the
    reference's unsharded ragged run."""
    wins = te.synthetic_ragged_windows(8, N, 6, lengths=LENGTHS, seed=3, device="cpu")
    ref_wins = reng.synthetic_ragged_windows(8, N, 6, lengths=LENGTHS, seed=3)
    inputs = te.pack_fleet_inputs(*wins, step_windows=N_W, lengths=LENGTHS, device="cpu")
    ref_in = reng.pack_fleet_inputs(*ref_wins, step_windows=N_W, lengths=LENGTHS)
    assert inputs.mask is not None
    _assert_result_close(
        getattr(te, name)(inputs, CFG, mesh=_mesh(k)), getattr(reng, name)(ref_in, REF_CFG)
    )


# ---------------------------------------------------------------------------
# Fleet-level reductions: per-shard partials + one sum == plain sums.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("variant", ["plain", "mask", "chip"])
def test_fleet_attribution_totals_match_reference(k, variant):
    _, inputs = _fleets(8, 2, 10, 7, seed=k)
    res = te.run_fleet(inputs, CFG, device="cpu")
    rng = np.random.default_rng(k)
    kw, ref_kw = {}, {}
    tp, ua = res.tick_power, res.unattributed
    if variant == "mask":
        mask = (rng.random((8, 20)) > 0.3).astype(np.float32)
        tp = tp + 13.0 * torch.from_numpy(1.0 - mask)[..., None]  # junk the mask must excise
        kw["mask"], ref_kw["mask"] = torch.from_numpy(mask), jnp.asarray(mask)
    if variant == "chip":
        chip = (rng.random((8, 7)) * 30.0).astype(np.float32)
        kw["chip_power"], ref_kw["chip_power"] = torch.from_numpy(chip), jnp.asarray(chip)
    cp = res.x_final[:, -1]
    want = ref_totals(jnp.asarray(tp.numpy()), jnp.asarray(ua.numpy()), jnp.asarray(cp.numpy()), **ref_kw)
    got = fleet_attribution_totals(tp, ua, cp, mesh=_mesh(k), **kw)
    plain = fleet_attribution_totals(tp, ua, cp, **kw)
    for name, g, p, w in zip(want._fields, got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    # conservation: per-function totals sum to the attributed total
    np.testing.assert_allclose(float(got.per_fn.sum()), float(got.attributed), rtol=1e-5)


# ---------------------------------------------------------------------------
# Reshard: the checkpoint keeps the bits.
# ---------------------------------------------------------------------------


def test_reshard_round_trip_keeps_bits():
    _, inputs = _fleets(4, 1, 5, 3, seed=2)
    x0 = te.fleet_initial_estimate(inputs.c, inputs.w, CFG)
    state = te.fleet_stream_init(x0, 5, device="cpu")
    state, _ = te.fleet_step(state, te.fleet_ticks(inputs).at(0), CFG)
    there = reshard(state, _mesh(4))
    back = reshard(there, None)
    assert isinstance(there, Shards) and not isinstance(back, Shards)
    assert back.tick_in_step == state.tick_in_step == 1
    for a, b in zip((back.c_buf, back.w_buf, *back.kalman), (state.c_buf, state.w_buf, *state.kalman)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# ---------------------------------------------------------------------------
# Profiler + control-plane surface.
# ---------------------------------------------------------------------------


def _fleet_fixture(b=2, duration=150.0):
    reg = ref_paper_functions()
    traces = [
        ref_generate_trace(reg, RefWorkloadConfig(duration_s=duration, load=1.0, seed=3 + i))
        for i in range(b)
    ]
    sims = RefSimulator(reg, RefSimConfig(platform="edge")).simulate_fleet(traces, seeds=list(range(b)))
    arrays = [(t.fn_id, t.start, t.end) for t in traces]
    return traces, [s.telemetry for s in sims], arrays


@pytest.mark.parametrize("k", [1, 2])
def test_fleet_profile_batched_sharded_matches(k):
    """The port's batched profiler, sharded over k entries, against the
    reference's unsharded one (the simulator's numpy telemetry is shared)."""
    traces, tels, arrays = _fleet_fixture(b=2)
    kw = dict(num_fns=traces[0].num_fns, duration=traces[0].duration)
    small = dict(init_windows=60, step_windows=30)
    ref = ref_fleet_profile_batched(
        RefProfiler(RefProfilerConfig(**small)),
        [tuple(jnp.asarray(x) for x in a) for a in arrays], tels, **kw,
    )
    f = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    port_tels = [
        telemetry_from_numpy(
            f(t.system_power), f(t.chip_power), t.idle_watts, f(t.cp_cpu_frac), f(t.sys_cpu_frac),
            device="cpu",
        )
        for t in tels
    ]
    out = fleet_profile_batched(
        FaasMeterProfiler(ProfilerConfig(**small)), arrays, port_tels, mesh=_mesh(k), **kw
    )
    for r, o in zip(ref, out):
        assert _scaled(o.x_power, r.x_power) and _scaled(o.x_trajectory, r.x_trajectory)
        assert abs(o.total_error - r.total_error) < 1e-5


def _planes(seed=0):
    small = dict(init_windows=60, step_windows=30)
    ref = RefControlPlane(
        ref_paper_functions(), RefSimConfig(platform="edge", seed=seed), RefProfilerConfig(**small)
    )
    port = EnergyFirstControlPlane(
        paper_functions(), SimulatorConfig(platform="edge", seed=seed), ProfilerConfig(**small),
        device="cpu",
    )
    return ref, port


def _cp_traces(ref: bool, b=2):
    gen, cfg, reg = (
        (ref_generate_trace, RefWorkloadConfig, ref_paper_functions)
        if ref
        else (generate_trace, WorkloadConfig, paper_functions)
    )
    registry = reg()
    return [gen(registry, cfg(duration_s=150.0, load=1.0, seed=s)) for s in range(b)]


@pytest.mark.parametrize("slots", [None, 4])
def test_control_plane_explicit_mesh_matches_unsharded(slots):
    """profile_fleet with an explicit two-entry mesh (and through a pool of
    4 slots) reproduces the reference's single-device result: reports and
    live-fed trackers alike."""
    ref_cp, port_cp = _planes()
    want = ref_cp.profile_fleet(_cp_traces(True), seeds=[0, 1], mesh=None)
    got = port_cp.profile_fleet(_cp_traces(False), seeds=[0, 1], mesh=_mesh(2), slots=slots)
    for g, w in zip(got, want):
        assert _scaled(g.report.x_power, w.report.x_power)
        assert _scaled(g.footprint_stream.j_indiv, w.footprint_stream.j_indiv, 1e-4)
        assert g.footprint_stream.ticks_seen == w.footprint_stream.ticks_seen


def test_control_plane_auto_mesh_is_unsharded_on_one_device():
    """mesh="auto" resolves through fleet_mesh_auto: on a machine with at
    most one card that is None, so the result is the mesh=None one bit for
    bit; a mesh that is neither is refused."""
    if torch.cuda.device_count() > 1:
        pytest.skip("single-device semantics")
    _, port_cp = _planes()
    auto = port_cp.profile_fleet(_cp_traces(False), seeds=[0, 1])
    plain = port_cp.profile_fleet(_cp_traces(False), seeds=[0, 1], mesh=None)
    for a, b in zip(auto, plain):
        assert torch.equal(a.report.x_power, b.report.x_power)
        np.testing.assert_array_equal(a.footprint_stream.j_indiv, b.footprint_stream.j_indiv)
    with pytest.raises(ValueError, match="mesh must be"):
        port_cp.profile_fleet(_cp_traces(False), mesh="node")
    with pytest.raises(ValueError, match="mesh must be"):
        port_cp.profile_fleet(_cp_traces(False), mesh=2)
