"""Port vs reference: the closed energy-control loop (``ControlLoop``), the
power-cap controllers, the energy-aware scheduler and ``run_capped``.

Mirrors ``tests/test_control_loop.py`` at its own shapes.  The loop runs one
causal control round against the live streaming replay in combined mode,
then the reshaped ``controlled_traces()`` are re-simulated; the invariants
(work conserved, starts only forward, overshoot reduced) are checked on
that second pass, as in the reference.  Against the reference, given the
same seeded NumPy traces: every admission and placement decision is equal
(the controlled traces equal bitwise, and so the re-simulated power), the
bill within 1e-5 relative, and the retrain errors within 1e-5 of scale.
The port runs on the CPU (``device="cpu"``).
"""

import dataclasses

import numpy as np
import pytest

from repro.core.capping import CappingConfig as RefCappingConfig
from repro.core.capping import FleetPowerCapController as RefFleetCap
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.serving.control_plane import ControlConfig as RefControlConfig
from repro.serving.control_plane import ControlLoop as RefControlLoop
from repro.serving.control_plane import EnergyFirstControlPlane as RefControlPlane
from repro.serving.scheduler import EnergyAwareScheduler as RefScheduler
from repro.serving.scheduler import Invocation as RefInvocation
from repro.serving.scheduler import SchedulerConfig as RefSchedulerConfig
from repro.serving.scheduler import energy_aware_placement as ref_placement
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.telemetry.simulator import chip_drift_transform as ref_drift
from repro.workload.azure import WorkloadConfig as RefWorkloadConfig
from repro.workload.azure import fleet_traces as ref_fleet_traces
from repro.workload.functions import paper_functions as ref_paper_functions
from repro_torch.core.capping import CappingConfig, FleetPowerCapController
from repro_torch.core.profiler import ProfilerConfig
from repro_torch.serving import (
    CapRunResult,
    ControlConfig,
    ControlLoop,
    EnergyAwareScheduler,
    EnergyFirstControlPlane,
    Invocation,
    SchedulerConfig,
    energy_aware_placement,
)
from repro_torch.telemetry.simulator import SimulatorConfig, chip_drift_transform
from repro_torch.workload.functions import paper_functions

SMALL = dict(init_windows=60, step_windows=30)


def _controlled_run(*, ref=False, duration=240.0, load=6.0, nodes=3, seed=3, quantile=0.85, drift=None, **ctl_kw):
    """One closed-loop replay of either package on the same NumPy traces:
    (control plane, traces, uncontrolled (B, N) power, cap, finished loop)."""
    traces = ref_fleet_traces(ref_paper_functions(), RefWorkloadConfig(duration_s=duration, load=load, seed=seed), nodes)
    if ref:
        cp = RefControlPlane(ref_paper_functions(), RefSimConfig(platform="server", seed=0), RefProfilerConfig(**SMALL))
        extra = dict(mesh=None, tick_transform=ref_drift(*drift) if drift else None)
        loop_cls, cfg_cls = RefControlLoop, RefControlConfig
    else:
        cp = EnergyFirstControlPlane(
            paper_functions(), SimulatorConfig(platform="server", seed=0), ProfilerConfig(**SMALL), device="cpu"
        )
        extra = dict(tick_transform=chip_drift_transform(*drift) if drift else None)
        loop_cls, cfg_cls = ControlLoop, ControlConfig
    w = np.stack([np.asarray(s.telemetry.system_power) for s in cp.simulator.simulate_fleet(traces, None)])
    cap = float(np.quantile(w, quantile))
    loop = loop_cls(cfg_cls(cap_watts=cap, **ctl_kw))
    cp.profile_fleet(traces, mode="combined", control=loop, **extra)
    return cp, traces, w, cap, loop


def _resimulate(cp, loop):
    ct = loop.controlled_traces()
    return ct, np.stack([np.asarray(s.telemetry.system_power) for s in cp.simulator.simulate_fleet(ct, None)])


def _counts_per_fn(traces, num_fns):
    out = np.zeros((len(traces), num_fns))
    for i, t in enumerate(traces):
        valid = t.fn_id >= 0
        np.add.at(out[i], t.fn_id[valid], 1.0)
    return out


def _busy_per_fn(traces, num_fns):
    out = np.zeros((len(traces), num_fns))
    for i, t in enumerate(traces):
        valid = t.fn_id >= 0
        np.add.at(out[i], t.fn_id[valid], (t.end - t.start)[valid].astype(np.float64))
    return out


def _assert_same_schedule(port_ct, ref_ct):
    for p, r in zip(port_ct, ref_ct):
        np.testing.assert_array_equal(p.fn_id, r.fn_id)
        np.testing.assert_array_equal(p.start, r.start)
        np.testing.assert_array_equal(p.end, r.end)
        assert p.duration == r.duration


def _assert_same_summary(port, ref):
    ps, rs = port.summary(), ref.summary()
    assert ps.pop("billed_joules") == pytest.approx(rs.pop("billed_joules"), rel=1e-5)
    assert ps == rs


class TestControlLoopSmall:
    """Moderate-load replay: invariants of any controlled run, and the
    reference's decisions."""

    @pytest.fixture(scope="class")
    def run(self):
        cp, traces, w, cap, loop = _controlled_run()
        ct, wc = _resimulate(cp, loop)
        return cp, traces, w, cap, loop, ct, wc

    def test_overshoot_fraction_bounds(self, run):
        _, _, _, _, loop, _, _ = run
        assert 0.0 <= loop.fleet.stats.overshoot_fraction <= 1.0
        summ = loop.summary()
        assert 0.0 <= summ["observed_overshoot_fraction"] <= 1.0
        assert summ["deferred_by_cap"] >= 0 and summ["mean_queue_wait_s"] >= 0.0
        assert summ["max_queue_wait_s"] >= summ["mean_queue_wait_s"]
        assert np.isfinite(summ["billed_joules"]) and summ["billed_joules"] > 0

    def test_controlled_overshoot_below_uncontrolled(self, run):
        _, _, w, cap, _, _, wc = run
        assert float(np.mean(wc > cap)) < float(np.mean(w > cap))

    def test_admission_conserves_work(self, run):
        """Deferral moves starts, never drops or duplicates work."""
        _, traces, _, _, _, ct, _ = run
        np.testing.assert_array_equal(_counts_per_fn(traces, 7).sum(0), _counts_per_fn(ct, 7).sum(0))
        np.testing.assert_allclose(_busy_per_fn(traces, 7).sum(0), _busy_per_fn(ct, 7).sum(0), rtol=1e-5, atol=1e-2)

    def test_starts_only_move_forward(self, run):
        _, traces, _, _, _, ct, _ = run
        orig = np.sort(np.concatenate([(t.end - t.start)[t.fn_id >= 0] for t in traces]))
        ctrl = np.sort(np.concatenate([(t.end - t.start)[t.fn_id >= 0] for t in ct]))
        np.testing.assert_allclose(orig, ctrl, rtol=1e-5, atol=2e-3)
        t_orig = np.concatenate([t.start[t.fn_id >= 0] for t in traces])
        t_ctrl = np.concatenate([t.start[t.fn_id >= 0] for t in ct])
        assert t_ctrl.sum() >= t_orig.sum() - 1e-3

    def test_live_price_meter_bills_during_segment(self, run):
        _, _, _, _, loop, _, _ = run
        assert loop.meter.ticks_seen > 0 and float(np.sum(loop.meter.j_total)) > 0.0
        np.testing.assert_allclose(
            float(np.sum(loop.meter.j_total)),
            float(np.sum(loop.meter.j_indiv)) + loop.meter.idle_joules,
            rtol=1e-9,
        )

    def test_decisions_equal_the_reference(self, run):
        """Every admission and placement of the reference's loop, fed the
        same traces: equal controlled traces, re-simulated power, cap
        statistics and queue waits; the live bill to 1e-5."""
        cp, _, _, _, loop, ct, wc = run
        ref_cp, _, _, _, ref_loop = _controlled_run(ref=True)
        ref_ct, ref_wc = _resimulate(ref_cp, ref_loop)
        _assert_same_schedule(ct, ref_ct)
        np.testing.assert_array_equal(wc, ref_wc)
        _assert_same_summary(loop, ref_loop)
        np.testing.assert_allclose(loop.meter.j_total, ref_loop.meter.j_total, rtol=1e-5)


def test_no_migration_preserves_per_node_work():
    cp, traces, _, _, loop = _controlled_run(duration=150.0, load=4.0, nodes=2, seed=5, placement=False)
    ct, _ = _resimulate(cp, loop)
    np.testing.assert_array_equal(_counts_per_fn(traces, 7), _counts_per_fn(ct, 7))
    np.testing.assert_allclose(_busy_per_fn(traces, 7), _busy_per_fn(ct, 7), rtol=1e-5, atol=1e-2)


def test_bitwise_deterministic_replay():
    """Two replays of one controlled run give the same bits: schedules,
    re-simulated power and summaries (the trace statistics and the retrain
    checks are host computations in a fixed order)."""
    outs = []
    for _ in range(2):
        cp, _, _, _, loop = _controlled_run(duration=150.0, load=4.0, nodes=2, seed=5)
        ct, wc = _resimulate(cp, loop)
        outs.append((ct, wc, loop.summary()))
    (ct0, wc0, s0), (ct1, wc1, s1) = outs
    _assert_same_schedule(ct0, ct1)
    np.testing.assert_array_equal(wc0, wc1)
    assert s0 == s1


# ---------------------------------------------------------------------------
# Placement and scheduler semantics, driven directly, against the reference.
# ---------------------------------------------------------------------------


def _cap(cls, cap=200.0):
    return cls(power_cap_watts=cap, control_interval_s=1.0)


def _both(fn):
    """Run a scenario on the port's classes and on the reference's."""
    port = fn(CappingConfig, FleetPowerCapController, energy_aware_placement,
              EnergyAwareScheduler, SchedulerConfig, Invocation)
    ref = fn(RefCappingConfig, RefFleetCap, ref_placement, RefScheduler, RefSchedulerConfig, RefInvocation)
    assert port == ref, (port, ref)
    return port


def _sched(Sched, SCfg, Cap):
    return Sched(SCfg(capping=_cap(Cap)), executor=lambda inv: inv.payload["dur"],
                 footprint_of=lambda fn: 5.0, mean_latency_of=lambda fn: 1.0)


def test_placement_prefers_headroom():
    def scenario(Cap, Fleet, place, *_):
        fleet = Fleet(_cap(Cap), 3)
        fleet.observe_power(np.asarray([150.0, 50.0, 100.0]))
        return place(fleet, 10.0, 1.0)

    assert _both(scenario) == 1


def test_placement_respects_live_mask():
    def scenario(Cap, Fleet, place, *_):
        fleet = Fleet(_cap(Cap), 3)
        fleet.observe_power(np.asarray([150.0, 50.0, 100.0]))
        return place(fleet, 10.0, 1.0, live=np.asarray([True, False, True]))

    assert _both(scenario) == 2


def test_placement_none_when_no_headroom():
    def scenario(Cap, Fleet, place, *_):
        fleet = Fleet(_cap(Cap), 2)
        fleet.observe_power(np.asarray([199.0, 199.0]))
        return place(fleet, 50.0, 1.0)

    assert _both(scenario) is None


def test_would_admit_probe_is_pure():
    def scenario(Cap, Fleet, *_):
        fleet = Fleet(_cap(Cap), 2)
        fleet.observe_power(np.asarray([50.0, 50.0]))
        before = fleet.stats.decisions
        return fleet.would_admit(0, 10.0, 1.0), fleet.stats.decisions - before, fleet.nodes[0]._current_power

    assert _both(scenario) == (True, 0, 50.0)


def test_drain_fleet_no_migration_uses_origin_node():
    def scenario(Cap, Fleet, place, Sched, SCfg, Inv):
        s = _sched(Sched, SCfg, Cap)
        fleet = Fleet(_cap(Cap), 2)
        fleet.observe_power(np.asarray([0.0, 0.0]))
        s.submit(Inv("f", arrival=0.0, payload={"node": 1, "dur": 1.0}))
        return [n for _, n in s.drain_fleet(2.0, fleet=fleet, placement=False)]

    assert _both(scenario) == [1]


def test_deferred_invocation_restarts_at_admitting_window():
    def scenario(Cap, Fleet, place, Sched, SCfg, Inv):
        s = _sched(Sched, SCfg, Cap)
        fleet = Fleet(_cap(Cap), 1)
        fleet.observe_power(np.asarray([0.0]))
        s.submit(Inv("f", arrival=0.5, payload={"node": 0, "dur": 1.0}))
        ((inv, _),) = s.drain_fleet(3.0, fleet=fleet)
        return inv.started_at, inv.queue_wait

    assert _both(scenario) == (3.0, pytest.approx(2.5))


def test_same_window_admission_keeps_arrival():
    def scenario(Cap, Fleet, place, Sched, SCfg, Inv):
        s = _sched(Sched, SCfg, Cap)
        fleet = Fleet(_cap(Cap), 1)
        fleet.observe_power(np.asarray([0.0]))
        s.submit(Inv("f", arrival=4.5, payload={"node": 0, "dur": 1.0}))
        ((inv, _),) = s.drain_fleet(4.0, fleet=fleet)
        return inv.started_at, inv.queue_wait

    assert _both(scenario) == (4.5, 0.0)


def test_head_of_line_blocking():
    def scenario(Cap, Fleet, place, Sched, SCfg, Inv):
        s = _sched(Sched, SCfg, Cap)
        fleet = Fleet(Cap(power_cap_watts=100.0, control_interval_s=1.0), 1)
        fleet.observe_power(np.asarray([97.0]))  # the head's 5 J / 1 s won't fit
        s.submit(Inv("big", arrival=0.0, payload={"node": 0, "dur": 1.0}))
        s.submit(Inv("small", arrival=0.0, payload={"node": 0, "dur": 1.0}))
        return s.drain_fleet(1.0, fleet=fleet), len(s.queue), s.stats.deferred_by_cap

    assert _both(scenario) == ([], 2, 1)


def test_aimd_guard_band_and_stats_follow_the_reference():
    """A power series crossing the cap: guard band, headroom and every
    ``CapStats`` field equal the reference's after each sample."""
    rng = np.random.default_rng(9)
    series = 150.0 + 80.0 * rng.random((40, 3))

    def scenario(Cap, Fleet, *_):
        fleet = Fleet(_cap(Cap), 3)
        trail = []
        for row in series:
            fleet.observe_power(row, valid=row < 225.0)
            fleet.admit(int(np.argmax(fleet.headroom_watts())), 4.0, 2.0)
            st = fleet.stats
            trail.append((tuple(fleet.headroom_watts()), st.overshoot_samples, st.admitted, st.deferred,
                          st.max_overshoot_frac, st.sum_overshoot_frac))
        return trail

    _both(scenario)


# ---------------------------------------------------------------------------
# Retrain on stream, resync.
# ---------------------------------------------------------------------------


class TestRetrainOnStream:
    @pytest.fixture(scope="class")
    def drifted(self):
        return _controlled_run(duration=300.0, load=4.0, nodes=2, seed=11, drift=(1.4, 120.0))

    def test_drift_triggers_retrain_and_recovers(self, drifted):
        """Mid-stream chip drift -> retrain_needed fires -> the sliding-window
        refit swaps models in and the errors recover below the threshold."""
        _, _, _, _, loop = drifted
        errs = np.stack(loop.session.model_errors)
        thr = loop.session._retrain_cfg.retrain_threshold
        assert errs[0].max() < thr and errs.max() > thr
        assert loop.retrain_events and len(loop.session.refits) >= 1
        assert errs[-1].max() < thr and errs[-1].max() < errs.max() / 3

    def test_retrain_matches_the_reference(self, drifted):
        """The same refits at the same ticks, per-step model errors at 1e-5
        of scale, and the same controlled schedule."""
        cp, _, _, _, loop = drifted
        ref_cp, _, _, _, ref_loop = _controlled_run(ref=True, duration=300.0, load=4.0, nodes=2, seed=11, drift=(1.4, 120.0))
        assert [(t, f.tolist()) for t, f in loop.retrain_events] == [(t, f.tolist()) for t, f in ref_loop.retrain_events]
        errs, ref_errs = np.stack(loop.session.model_errors), np.stack(ref_loop.session.model_errors)
        assert float(np.abs(errs - ref_errs).max()) <= 1e-5 * max(1.0, float(np.abs(ref_errs).max()))
        _assert_same_schedule(loop.controlled_traces(), ref_loop.controlled_traces())

    def test_retrain_disabled_leaves_errors_high(self):
        _, _, _, _, loop = _controlled_run(duration=300.0, load=4.0, nodes=2, seed=11, retrain=False, drift=(1.4, 120.0))
        errs = np.stack(loop.session.model_errors)
        assert not loop.retrain_events and not loop.session.refits
        assert errs[-1].max() > loop.session._retrain_cfg.retrain_threshold


def test_resync_events_recorded():
    """Skews re-estimated every two steps, never past the bootstrap
    lookahead (the causality clamp)."""
    _, _, _, _, loop = _controlled_run(duration=240.0, load=4.0, nodes=2, seed=5, resync_every_steps=2)
    assert loop.resync_events and loop.session.skew_history
    for _, skews in loop.session.skew_history:
        assert np.all(skews <= loop.session._lookahead + 1e-9)


def test_control_loop_is_single_use_and_needs_bind():
    loop = ControlLoop(ControlConfig(cap_watts=100.0))
    with pytest.raises(ValueError, match="before bind"):
        loop.on_tick(None, [])
    with pytest.raises(ValueError, match="needs finish"):
        loop.controlled_traces()


# ---------------------------------------------------------------------------
# run_capped (Fig. 10).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_footprints", [True, False], ids=["footprints", "static-buffer"])
def test_run_capped_matches_reference(use_footprints):
    """The single-node discrete-event capping run on one trace: power
    series, queue waits, latencies and cap statistics equal the
    reference's; the cap cuts the uncapped run's overshoot."""
    trace = ref_fleet_traces(ref_paper_functions(), RefWorkloadConfig(duration_s=120.0, load=3.0, seed=2), 1)[0]
    cp = EnergyFirstControlPlane(paper_functions(), device="cpu")
    ref_cp = RefControlPlane(ref_paper_functions())
    free = cp.run_capped(trace, float("inf"))
    cap = float(np.quantile(free.power_series, 0.8))
    got = cp.run_capped(trace, cap, use_footprints=use_footprints)
    want = ref_cp.run_capped(trace, cap, use_footprints=use_footprints)
    assert isinstance(got, CapRunResult)
    np.testing.assert_array_equal(got.power_series, want.power_series)
    np.testing.assert_array_equal(got.queue_waits, want.queue_waits)
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.overshoot_fraction == want.overshoot_fraction
    assert got.mean_overshoot_magnitude == want.mean_overshoot_magnitude
    assert np.mean(free.power_series > cap) > got.overshoot_fraction
