"""Port vs reference: the live streaming session and the control plane.

``StreamingFleetSession`` (through ``FaasMeterProfiler.start_fleet_stream``)
and ``EnergyFirstControlPlane.profile_fleet`` of both packages are fed the
same seeded traces and telemetry.  Reports and live ticks are pinned at 1e-5
of their scale (per-tick power at 1e-4), skews at 1e-5 windows; tracker
footprints at 1e-5 of scale; the drained ingest equals the inline one
bitwise (tests/test_drain.py's contract).  The dispatch stage's no-wait
contract is checked here by refusing every host read of a tensor between
the first engine tick and the last (on the card, ``chip_smoke.py`` runs it
under ``torch.cuda.set_sync_debug_mode("error")``).
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.profiler import FaasMeterProfiler as RefProfiler
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.core.profiler import fleet_profile_batched as ref_fleet_profile_batched
from repro.serving.control_plane import EnergyFirstControlPlane as RefControlPlane
from repro.telemetry.simulator import NodeSimulator as RefSimulator
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.workload.azure import WorkloadConfig as RefWorkloadConfig
from repro.workload.azure import generate_trace as ref_generate_trace
from repro.workload.functions import paper_functions as ref_paper_functions
from repro_torch.core.engine import fleet_stream_init, run_fleet_stream, synthetic_fleet
from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
from repro_torch.data import prefetch_iterator
from repro_torch.serving import EnergyFirstControlPlane, StreamingFootprintTracker
from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
from repro_torch.workload.azure import WorkloadConfig, generate_trace
from repro_torch.workload.functions import paper_functions

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
DURATION = 150.0  # 60 init + 3 Kalman steps of 30
SMALL = dict(init_windows=60, step_windows=30)


def _scaled(port, ref, rel=1e-5):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.cpu().numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    return float(np.max(np.abs(port - ref), initial=0.0)) <= rel * max(1.0, float(np.abs(ref).max(initial=0.0)))


def _assert_report(port, ref, what=""):
    assert abs(port.skew_windows - ref.skew_windows) <= 1e-5, (what, port.skew_windows, ref.skew_windows)
    for name in ("x_power", "x_trajectory", "x_cp", "mean_latency", "invocations"):
        assert _scaled(getattr(port, name), getattr(ref, name)), (what, name)
    for name in ("j_indiv", "j_total"):
        assert _scaled(getattr(port.spectrum, name), getattr(ref.spectrum, name)), (what, name)
    assert port.total_error == pytest.approx(ref.total_error, rel=1e-5, abs=1e-6), what
    assert port.cp_energy == pytest.approx(ref.cp_energy, rel=1e-5, abs=1e-3), what
    assert port.idle_energy == pytest.approx(ref.idle_energy, rel=1e-6), what


def _fleet(platform="edge", seeds=(1, 2), sim_seeds=(11, 12), duration=DURATION):
    """The reference's traces, telemetry and tick stream (numpy), which both
    packages' sessions consume."""
    reg = ref_paper_functions()
    traces = [
        ref_generate_trace(reg, RefWorkloadConfig(duration_s=duration, load=1.0, seed=s))
        for s in seeds
    ]
    sim = RefSimulator(reg, RefSimConfig(platform=platform))
    tels = [s.telemetry for s in sim.simulate_fleet(traces, seeds=list(sim_seeds))]
    ticks = list(sim.stream_fleet(traces, seeds=list(sim_seeds)))
    arrays = [(t.fn_id, t.start, t.end) for t in traces]
    return traces, tels, ticks, arrays


def _session(profiler, arrays, tels, *, ref=False, duration=DURATION, **kw):
    if ref:
        arrays = [tuple(jnp.asarray(x) for x in a) for a in arrays]
    else:
        kw.setdefault("device", "cpu")
    return profiler.start_fleet_stream(
        arrays, num_fns=7, duration=duration,
        idle_watts=[t.idle_watts for t in tels],
        has_chip=tels[0].chip_power is not None,
        has_cp=tels[0].cp_cpu_frac is not None,
        **kw,
    )


def _live_threads(name):
    return [t for t in threading.enumerate() if t.name == name and t.is_alive()]


def _assert_no_leak(name, before, wait=False):
    if wait:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(_live_threads(name)) > before:
            time.sleep(0.02)
    assert len(_live_threads(name)) <= before, f"{name} thread leaked"


@pytest.mark.parametrize("platform", ["edge", "server"])
def test_session_matches_reference(platform):
    """The edge fleet (no chip: no sync) and a synced server fleet: skews,
    every live tick and the finalized reports agree with the reference
    session fed the same windows."""
    traces, tels, ticks, arrays = _fleet(platform)
    ref_ticks, port_ticks = [], []
    ref = _session(RefProfiler(RefProfilerConfig(**SMALL)), arrays, tels, ref=True, on_tick=ref_ticks.append)
    ref.ingest(iter(ticks), prefetch=2)
    port = _session(FaasMeterProfiler(ProfilerConfig(**SMALL)), arrays, tels, on_tick=port_ticks.append)
    port.ingest(iter(ticks), prefetch=2)
    np.testing.assert_allclose(port.skews, ref.skews, rtol=0, atol=1e-5)
    if platform == "server":
        assert np.all(np.abs(ref.skews) > 0.5)  # the sync really shifts
    assert [tk.t for tk in port_ticks] == [tk.t for tk in ref_ticks] == list(range(60, 150))
    for p, r in zip(port_ticks, ref_ticks):
        assert p.step_completed == r.step_completed
        assert _scaled(p.x, r.x), p.t
        assert _scaled(p.tick_power, r.tick_power, 1e-4), p.t
        np.testing.assert_array_equal(p.w_sys, r.w_sys)
        np.testing.assert_array_equal(p.target, r.target)
        np.testing.assert_array_equal(p.busy_seconds, r.busy_seconds)
        np.testing.assert_array_equal(p.a, r.a)
    for i, (p, r) in enumerate(zip(port.finalize(), ref.finalize())):
        _assert_report(p, r, f"{platform} node {i}")


@pytest.mark.parametrize("platform", ["edge", "server"])
def test_drained_ingest_bitwise_equals_inline(platform):
    """drain=True changes where emission runs, never what is computed."""
    traces, tels, ticks, arrays = _fleet(platform)
    profiler = FaasMeterProfiler(ProfilerConfig(**SMALL))

    def run(drain):
        emitted = []
        sess = _session(profiler, arrays, tels, on_tick=emitted.append)
        sess.ingest(iter(ticks), prefetch=2, drain=drain)
        return emitted, sess.finalize()

    inline_ticks, inline_reports = run(False)
    drained_ticks, drained_reports = run(True)
    assert [tk.t for tk in drained_ticks] == [tk.t for tk in inline_ticks]
    for a, b in zip(inline_ticks, drained_ticks):
        assert a.step_completed == b.step_completed
        for name in ("x", "tick_power", "unattributed", "busy_seconds", "a", "target", "w_sys"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for ra, rb in zip(inline_reports, drained_reports):
        for name in ("x_power", "x_trajectory", "x_cp"):
            torch.testing.assert_close(getattr(ra, name), getattr(rb, name), rtol=0, atol=0)
        torch.testing.assert_close(ra.spectrum.j_total, rb.spectrum.j_total, rtol=0, atol=0)
        assert ra.total_error == rb.total_error


def test_drained_step_boundaries_follow_plan():
    traces, tels, ticks, arrays = _fleet()
    emitted = []
    sess = _session(FaasMeterProfiler(ProfilerConfig(**SMALL)), arrays, tels, on_tick=emitted.append)
    sess.ingest(iter(ticks), prefetch=2, drain=True)
    assert len(emitted) == sess.s * 30 == sess.ticks_dispatched
    for k, tk in enumerate(emitted):
        assert tk.step_completed == ((k + 1) % 30 == 0)


def test_drain_abandoned_midstream_joins_both_threads():
    """A source iterator dying mid-stream propagates its error and leaves
    neither the drain worker nor the prefetch producer behind."""
    traces, tels, ticks, arrays = _fleet()
    before_drain = len(_live_threads("session-drain"))
    before_prod = len(_live_threads("prefetch-producer"))
    sess = _session(FaasMeterProfiler(ProfilerConfig(**SMALL)), arrays, tels, on_tick=lambda tk: None)

    def dying(it, fail_at=100):
        for tk in it:
            if tk.t >= fail_at:  # past bootstrap: the engine is ticking
                raise RuntimeError("sensor fabric went away")
            yield tk

    with pytest.raises(RuntimeError, match="sensor fabric went away"):
        sess.ingest(dying(iter(ticks)), prefetch=2, drain=True)
    _assert_no_leak("session-drain", before_drain)
    _assert_no_leak("prefetch-producer", before_prod, wait=True)
    assert sess._drain is None


def test_drain_hook_exception_reraises_at_caller():
    traces, tels, ticks, arrays = _fleet()
    before_drain = len(_live_threads("session-drain"))
    before_prod = len(_live_threads("prefetch-producer"))

    def bad_hook(tick):
        if tick.t >= 100:
            raise ValueError("tracker rejected tick")

    sess = _session(FaasMeterProfiler(ProfilerConfig(**SMALL)), arrays, tels, on_tick=bad_hook)
    with pytest.raises(ValueError, match="tracker rejected tick"):
        sess.ingest(iter(ticks), prefetch=2, drain=True)
    _assert_no_leak("session-drain", before_drain)
    _assert_no_leak("prefetch-producer", before_prod, wait=True)


def test_drain_rejects_reentrant_ingest():
    traces, tels, ticks, arrays = _fleet()
    sess = _session(FaasMeterProfiler(ProfilerConfig(**SMALL)), arrays, tels)

    def reenter(it):
        yield next(it)
        with pytest.raises(ValueError, match="already running"):
            sess.ingest(iter([]), drain=True)
        yield from it

    sess.ingest(reenter(iter(ticks)), prefetch=2, drain=True)
    assert len(sess.finalize()) == len(arrays)


def test_dispatch_stage_reads_nothing_on_the_host(monkeypatch):
    """From the first engine tick to the last, a session with no ``on_tick``
    hook never reads a tensor's value on the host, and the carried buffers
    keep their storage for the whole stream."""
    traces, tels, ticks, arrays = _fleet("server")
    armed = {"on": False}
    reads = []

    def guard(name, orig):
        def guarded(self, *args, **kwargs):
            if armed["on"]:
                reads.append(name)
                raise AssertionError(f"the dispatch stage read a tensor on the host ({name})")
            return orig(self, *args, **kwargs)
        return guarded

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    ptrs = {}

    def arm(sess):
        ptrs.update(sess.buffer_pointers())
        armed["on"] = True

    sess = _session(FaasMeterProfiler(ProfilerConfig(**SMALL)), arrays, tels, on_bootstrap=arm)
    try:
        for tk in ticks:
            sess.push_window(tk.w_sys, tk.w_chip, tk.cp_frac, tk.sys_frac)
    finally:
        armed["on"] = False
    assert not reads
    assert sess.ticks_dispatched == 90 and sess.state.step_idx == 3
    assert sess.buffer_pointers() == ptrs and len(set(ptrs.values())) == len(ptrs)
    assert len(sess.finalize()) == 2


def _cp_traces(mod_generate, mod_config, mod_registry, spec):
    reg = mod_registry()
    return [mod_generate(reg, mod_config(duration_s=d, load=1.0, seed=s)) for s, d in spec]


def _assert_trackers(port_out, ref_out, ticks_expected):
    for p, r in zip(port_out, ref_out):
        tp, tr = p.footprint_stream, r.footprint_stream
        assert tp.ticks_seen == tr.ticks_seen == ticks_expected(p)
        assert tp.steps_seen == tr.steps_seen == tp.ticks_seen + 1
        assert tp.elapsed_s == pytest.approx(tr.elapsed_s)
        for name in ("per_invocation_indiv", "per_invocation_total", "j_indiv", "invocations"):
            assert _scaled(getattr(tp, name), getattr(tr, name)), name
        _assert_report(p.report, r.report)
        for k, v in r.prices.items():
            assert _scaled(p.prices[k], v), k


def test_profile_fleet_matches_reference():
    """The live per-tick feed: the hook's tick sequence, conservation on
    every tick, tracker counts and J/invocation, reports and prices."""
    spec = ((3, 180.0), (4, 180.0))
    ref_ticks, port_ticks = [], []

    def on_tick(seen):
        def hook(tick, trackers):
            seen.append(tick.t)
            recon = tick.tick_power.sum(-1) + tick.unattributed
            np.testing.assert_allclose(recon, tick.target, atol=1e-3)
        return hook

    ref = RefControlPlane(ref_paper_functions()).profile_fleet(
        _cp_traces(ref_generate_trace, RefWorkloadConfig, ref_paper_functions, spec),
        seeds=[21, 22], on_tick=on_tick(ref_ticks),
    )
    port = EnergyFirstControlPlane(paper_functions(), device="cpu").profile_fleet(
        _cp_traces(generate_trace, WorkloadConfig, paper_functions, spec),
        seeds=[21, 22], on_tick=on_tick(port_ticks),
    )
    assert port_ticks == ref_ticks == list(range(100, 160))
    _assert_trackers(port, ref, lambda p: 60)
    assert all(isinstance(p.footprint_stream, StreamingFootprintTracker) for p in port)


def test_profile_fleet_short_segment_has_no_tracker():
    spec = ((7, 90.0),)
    ref = RefControlPlane(ref_paper_functions()).profile_fleet(
        _cp_traces(ref_generate_trace, RefWorkloadConfig, ref_paper_functions, spec), seeds=[31]
    )
    port = EnergyFirstControlPlane(paper_functions(), device="cpu").profile_fleet(
        _cp_traces(generate_trace, WorkloadConfig, paper_functions, spec), seeds=[31]
    )
    assert len(port) == 1 and port[0].footprint_stream is None
    _assert_report(port[0].report, ref[0].report)


def test_profile_fleet_ragged_mixed_platforms():
    """Ragged durations on a mixed server/desktop/edge fleet (the edge node
    has no chip sensor): trackers stop with their node's stream, reports
    cover each node's own span."""
    spec = ((5, 150.0), (6, 120.0), (7, 135.0))
    platforms = ["server", "desktop", "edge"]
    ref = RefControlPlane(ref_paper_functions(), profiler_config=RefProfilerConfig(**SMALL)).profile_fleet(
        _cp_traces(ref_generate_trace, RefWorkloadConfig, ref_paper_functions, spec),
        seeds=[41, 42, 43], platforms=platforms,
    )
    port = EnergyFirstControlPlane(
        paper_functions(), profiler_config=ProfilerConfig(**SMALL), device="cpu"
    ).profile_fleet(
        _cp_traces(generate_trace, WorkloadConfig, paper_functions, spec),
        seeds=[41, 42, 43], platforms=platforms, drain=True,
    )
    _assert_trackers(port, ref, lambda p: ((int(p.trace.duration) - 60) // 30) * 30)
    assert port[2].report.skew_windows == 0.0


def test_paper_segment_gap_to_batched_is_the_reference_s():
    """At the paper's segment (1,800 s) the session's init-window skew moves
    a node's footprints further from ``fleet_profile_batched`` than the
    reference test's 2 W (tests/test_streaming_engine.py, 2 nodes x 180 s):
    node 58 of ``chip_smoke.py``'s 64-node fleet, run alone here, is 7.03 W
    away in the reference itself, and the port's gap is the reference's.
    (Over 28 Kalman steps the two packages' estimates part by up to 3.2e-4
    of scale on either path, FISTA amplifying last-bit differences.)"""
    node, dur = 58, 1800.0
    ref_tr = ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=dur, load=1.0, seed=node))
    ref_tel = RefSimulator(ref_paper_functions(), RefSimConfig()).simulate_fleet([ref_tr], seeds=[node])[0].telemetry
    ref_batched = ref_fleet_profile_batched(
        RefProfiler(RefProfilerConfig()), [tuple(jnp.asarray(x) for x in (ref_tr.fn_id, ref_tr.start, ref_tr.end))],
        [ref_tel], num_fns=7, duration=dur,
    )[0]
    ref_stream = RefControlPlane(ref_paper_functions()).profile_fleet([ref_tr], seeds=[node])[0].report
    tr = generate_trace(paper_functions(), WorkloadConfig(duration_s=dur, load=1.0, seed=node))
    tel = NodeSimulator(paper_functions(), SimulatorConfig()).simulate_fleet([tr], seeds=[node])[0].telemetry
    batched = fleet_profile_batched(
        FaasMeterProfiler(), [(tr.fn_id, tr.start, tr.end)], [tel], num_fns=7, duration=dur, device="cpu"
    )[0]
    stream = EnergyFirstControlPlane(paper_functions(), device="cpu").profile_fleet([tr], seeds=[node])[0].report
    ref_gap = float(np.abs(np.asarray(ref_stream.x_power) - np.asarray(ref_batched.x_power)).max())
    gap = float((stream.x_power - batched.x_power).abs().max())
    assert ref_gap > 2.0
    assert abs(stream.skew_windows - ref_stream.skew_windows) <= 1e-5
    assert abs(stream.skew_windows - batched.skew_windows) < 1.0
    assert abs(gap - ref_gap) <= 1e-3 * max(1.0, float(np.abs(np.asarray(ref_stream.x_power)).max()))


def test_profile_trace_and_marginal_energy_match_reference():
    ref_cp = RefControlPlane(ref_paper_functions())
    port_cp = EnergyFirstControlPlane(paper_functions(), device="cpu")
    ref_tr = ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=220.0, seed=9))
    port_tr = generate_trace(paper_functions(), WorkloadConfig(duration_s=220.0, seed=9))
    r, p = ref_cp.profile_trace(ref_tr, seed=5), port_cp.profile_trace(port_tr, seed=5)
    _assert_report(p.report, r.report)
    for k, v in r.prices.items():
        assert _scaled(p.prices[k], v), k
    assert port_cp.marginal_energy(port_tr, 2, seed=5) == ref_cp.marginal_energy(ref_tr, 2, seed=5)


def test_not_ported_branches_raise():
    """Slot pools and node-axis meshes (ROADMAP Queue 1 item 8) still raise
    ``NotImplementedError``.  Combined mode and ``control=`` are ported
    (tests/test_torch_combined.py, tests/test_torch_control_loop.py); what
    they refuse, they refuse with the reference's ``ValueError``: a chipless
    fleet in combined mode, a control loop without a tick stream, and a
    combined session without its counter inputs."""
    cp = EnergyFirstControlPlane(paper_functions(), device="cpu")
    traces = [generate_trace(paper_functions(), WorkloadConfig(duration_s=180.0, seed=1))]
    for kwargs in (dict(mesh=object()), dict(slots=4)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            cp.profile_fleet(traces, **kwargs)
    with pytest.raises(ValueError, match="mesh must be"):
        cp.profile_fleet(traces, mesh="everywhere")
    edge = EnergyFirstControlPlane(paper_functions(), SimulatorConfig(platform="edge"), device="cpu")
    with pytest.raises(ValueError, match="chip power source"):
        edge.profile_fleet(traces, mode="combined")
    short = [generate_trace(paper_functions(), WorkloadConfig(duration_s=90.0, seed=1))]
    with pytest.raises(ValueError, match="needs the streaming path"):
        cp.profile_fleet(short, control=object())
    _, tels, _, arrays = _fleet()
    profiler = FaasMeterProfiler(ProfilerConfig(**SMALL))
    for kwargs in (dict(mesh=object()), dict(slots=4)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            _session(profiler, arrays, tels, **kwargs)
    _, server_tels, _, server_arrays = _fleet("server")
    with pytest.raises(ValueError, match="fn_counters"):
        _session(FaasMeterProfiler(ProfilerConfig(mode="combined", **SMALL)), server_arrays, server_tels)
    with pytest.raises(ValueError, match="host arrays"):
        _session(profiler, [tuple(torch.as_tensor(x).to("meta") for x in a) for a in arrays], tels)
    with pytest.raises(ValueError, match="too short"):
        _session(profiler, arrays, tels, duration=70.0)


def test_entry_points_default_to_cuda_and_raise_without_it():
    """No device= means the card; without one each entry point raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnergyFirstControlPlane(paper_functions())
    _, tels, _, arrays = _fleet()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FaasMeterProfiler(ProfilerConfig(**SMALL)).start_fleet_stream(
            arrays, num_fns=7, duration=DURATION, idle_watts=[8.0, 8.0], has_chip=False, has_cp=True
        )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_stream_init(torch.ones(2, 3), 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fleet_stream(synthetic_fleet(2, 2, 4, 3, device="cpu"))


def test_prefetch_iterator_contract():
    """Order kept, a source error re-raised at the consumer, an abandoned
    iterator's producer joined, a non-positive size refused."""
    assert list(prefetch_iterator(iter(range(20)), size=3)) == list(range(20))

    def broken():
        yield 1
        raise KeyError("source died")

    it = prefetch_iterator(broken(), size=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="source died"):
        next(it)
    before = len(_live_threads("prefetch-producer"))
    it = prefetch_iterator(iter(range(1000)), size=2)
    assert next(it) == 0
    it.close()
    _assert_no_leak("prefetch-producer", before)
    with pytest.raises(ValueError, match="size"):
        next(prefetch_iterator(iter([]), size=0))


def test_control_plane_imports_neither_jax_nor_reference():
    """Running profile_fleet on the CPU loads no module of JAX or of the
    reference package."""
    code = textwrap.dedent(
        """
        import sys
        from repro_torch.core.profiler import ProfilerConfig
        from repro_torch.serving import EnergyFirstControlPlane
        from repro_torch.workload.azure import WorkloadConfig, fleet_traces
        from repro_torch.workload.functions import paper_functions
        reg = paper_functions()
        cp = EnergyFirstControlPlane(reg, profiler_config=ProfilerConfig(init_windows=40, step_windows=30), device="cpu")
        out = cp.profile_fleet(fleet_traces(reg, WorkloadConfig(duration_s=130.0), 2), drain=True)
        assert all(p.footprint_stream.ticks_seen == 90 for p in out)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
