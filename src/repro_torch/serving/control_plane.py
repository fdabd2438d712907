"""Energy-first FaaS control plane (paper Fig. 1, §5, §6.3) -- the port of
the reference's ``repro/serving/control_plane.py``.

Ties together workload -> telemetry -> FaasMeter profiling -> footprints ->
pricing:

- ``EnergyFirstControlPlane.profile_trace``: trace-driven, one node.
- ``EnergyFirstControlPlane.profile_fleet``: the *streaming* fleet path —
  telemetry is fed window-by-window into a ``StreamingFleetSession``, each
  engine tick updates every node's ``StreamingFootprintTracker`` live, and
  the ``on_tick`` hook sees conserved per-tick attribution; in pure or
  combined (§4.3) mode, and with ``control=`` closed by a ``ControlLoop``:
  capped admission and energy-aware placement from live footprints, a live
  bill, and model maintenance (retrain, resync) on the stream.
- ``EnergyFirstControlPlane.run_capped``: discrete-event execution under a
  software power cap (paper Fig. 10): arrivals queue, the head of the queue
  is admitted iff ``W*t + J_lambda <= W_cap*t`` using footprints, and
  deferred invocations wait.
- ``MeteredServer`` (real-exec): actual model invocations on this host,
  timed and traced for metering.

Not yet ported (ROADMAP Queue 1 item 8): slot pools and node-axis meshes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.capping import CappingConfig, FleetPowerCapController, PowerCapController
from repro_torch.core.engine.segment import _NO_MESH
from repro_torch.core.pricing import LivePriceMeter, PricingConfig, price_report
from repro_torch.core.profiler import (
    FaasMeterProfiler,
    FootprintReport,
    ProfilerConfig,
    fleet_profile,
    prepare_combined_fleet,
    segment_plan,
)
from repro_torch.core.sessions.base import _NO_SLOTS
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.serving.scheduler import EnergyAwareScheduler, Invocation, SchedulerConfig
from repro_torch.telemetry.simulator import (
    FleetTelemetryTick,
    NodeSimulator,
    SimResult,
    SimulatorConfig,
)
from repro_torch.workload.functions import FunctionRegistry
from repro_torch.workload.trace import InvocationTrace


@dataclasses.dataclass
class ProfiledWorkload:
    """One node's profiling outcome: report + simulation + prices.

    ``footprint_stream`` is the node's live-fed footprint tracker when the
    workload went through the streaming fleet path (None on the per-node /
    short-segment fallbacks).
    """

    report: FootprintReport
    sim: SimResult
    trace: InvocationTrace
    prices: dict
    footprint_stream: "StreamingFootprintTracker | None" = None


class StreamingFootprintTracker:
    """Streaming per-invocation footprint state for one node (numpy).

    Folds each observation — the init segment's X_0, or on the live path
    every single telemetry tick — into running footprints in O(M), so the
    control plane can serve per-invocation footprints that are always
    current without recomputing over history.
    """

    def __init__(self, num_fns: int, idle_watts: float = 0.0):
        self.num_fns = num_fns
        self.idle_watts = idle_watts
        self.j_indiv = np.zeros(num_fns)        # cumulative attributed joules
        self.invocations = np.zeros(num_fns)    # cumulative invocation counts
        self.elapsed_s = 0.0
        self.steps_seen = 0                     # observations folded in (any kind)
        self.ticks_seen = 0                     # of which: live per-tick feeds

    def observe_step(
        self,
        x_step: np.ndarray,        # (M+,) per-function power estimate (W)
        busy_seconds: np.ndarray,  # (M+,) per-function runtime in the interval (s)
        a_step: np.ndarray,        # (M+,) invocations starting in the interval
        step_seconds: float,
    ) -> None:
        """Fold one coarse observation (a Kalman step, the init segment)
        into the state; entries past ``num_fns`` (shared principals) are
        ignored, ``step_seconds`` feeds the idle-energy share."""
        self.j_indiv += np.asarray(busy_seconds[: self.num_fns], float) * np.asarray(
            x_step[: self.num_fns], float
        )
        self.invocations += np.asarray(a_step[: self.num_fns], float)
        self.elapsed_s += step_seconds
        self.steps_seen += 1

    def observe_tick(
        self,
        x_tick: np.ndarray,
        busy_seconds: np.ndarray,
        a_tick: np.ndarray,
        tick_seconds: float,
    ) -> None:
        """Fold one *live* engine tick into the state (``observe_step`` at
        tick granularity, under the causal estimate current at the tick)."""
        self.observe_step(x_tick, busy_seconds, a_tick, tick_seconds)
        self.ticks_seen += 1

    @property
    def per_invocation_indiv(self) -> np.ndarray:
        """(M,) running J/invocation of function execution alone."""
        return np.where(
            self.invocations > 0, self.j_indiv / np.maximum(self.invocations, 1.0), 0.0
        )

    @property
    def per_invocation_total(self) -> np.ndarray:
        """(M,) running J/invocation including the even idle-energy share
        over currently-active functions (§4.4 static-resource policy)."""
        active = self.invocations > 0
        n_active = max(int(active.sum()), 1)
        idle_j = self.idle_watts * self.elapsed_s / n_active
        total = self.j_indiv + np.where(active, idle_j, 0.0)
        return np.where(active, total / np.maximum(self.invocations, 1.0), 0.0)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Knobs for the streaming ``ControlLoop``.

    ``cap_watts`` is the per-node power cap (sensed system watts, same scale
    as the telemetry the loop observes).  ``capping`` overrides the derived
    ``CappingConfig`` wholesale when set.  ``placement=False`` pins every
    invocation to its origin node (the no-migration baseline);
    ``retrain``/``resync_every_steps`` gate the live model-maintenance side
    (combined mode only).
    """

    cap_watts: float
    use_footprints: bool = True
    placement: bool = True
    retrain: bool = True
    retrain_window_steps: int = 2
    resync_every_steps: int = 0
    # End-of-segment drain packs deferred work to cap*(1 - drain_margin):
    # footprints are estimates (and the host's power curve is sublinear in
    # concurrency), so packing to the exact cap would park every drain
    # window at the cap edge where estimate noise flips it over.
    drain_margin: float = 0.1
    pricing: PricingConfig = PricingConfig()
    capping: CappingConfig | None = None


class ControlLoop:
    """Closed-loop energy control over the live streaming fleet replay.

    This is the feedback layer that turns the profiler into a controller
    (paper Fig. 1: energy as a first-class control operation).  Driven from
    ``profile_fleet(control=...)``'s tick path, each conserved engine tick:

    1. feeds every node's sensed power to a per-node
       ``PowerCapController.observe_power`` (AIMD guard bands stay
       node-local, ``core.capping.FleetPowerCapController``);
    2. folds the tick's conserved attribution into a ``LivePriceMeter`` —
       the per-function bill is always current during the segment;
    3. submits the window's new arrivals to the ``EnergyAwareScheduler``
       and drains it: the head of the queue is placed on the node with the
       most cap headroom whose footprint-aware rule admits it
       (``scheduler.energy_aware_placement``), using *live* tracker
       footprints as J_lambda.  An invocation no node can take stays
       queued — deferred — and re-starts at the window that finally admits
       it, so capping visibly reshapes the trace;
    4. at Kalman-step boundaries, runs the model-maintenance side: when the
       session's ``retrain_needed`` fires, flagged nodes' counter models
       are re-fit on a sliding window in one fleet-batched call and written
       into the session's models in place (``session.refit_counter_models``);
       sync skew is re-estimated every ``resync_every_steps`` steps
       (``session.resync``).

    The loop is causal: decisions at tick ``t`` use only telemetry and
    footprints up to ``t``.  Telemetry was recorded from the *uncontrolled*
    replay, so within the loop the observed power is the baseline's — one
    control round against the live stream.  The controlled schedule's actual
    effect is then measured by re-simulating ``controlled_traces()`` (the
    reshaped per-node traces) through the same simulator; the paper's
    overshoot comparison (and the conservation tests) run on that second
    pass.  Arrivals inside the bootstrap init segment (no footprints yet)
    and past the engine's last full Kalman step pass through uncontrolled —
    the controller only reshapes what it could actually observe.
    """

    def __init__(self, config: ControlConfig):
        self.config = config
        self.session = None
        self.fleet: FleetPowerCapController | None = None
        self.meter: LivePriceMeter | None = None
        self.scheduler: EnergyAwareScheduler | None = None
        self.retrain_events: list[tuple[int, np.ndarray]] = []
        self.resync_events: list[int] = []
        self.drain_waits: list[float] = []
        self.ticks_seen = 0
        self._bound = False
        self._finished = False

    # -- wiring (called by profile_fleet) ----------------------------------

    def bind(
        self,
        *,
        traces: list[InvocationTrace],
        registry: FunctionRegistry,
        trackers: list,
        idle_watts,
        delta: float,
        init_n: int,
        n_used: int,
    ) -> None:
        """Attach the loop to one replay: precompute the fleet-wide arrival
        stream, build the capped-fleet controller, the live price meter, and
        the scheduler.  Arrivals before the init boundary are recorded into
        the controlled schedule verbatim (the controller has no footprints
        yet); everything from the init boundary to the engine's last tick is
        subject to admission control."""
        if self._bound:
            raise ValueError("ControlLoop is single-use: already bound to a replay")
        self._bound = True
        cfg = self.config
        self.registry = registry
        self.trackers = trackers
        self.delta = delta
        self.init_n = init_n
        self.n_used = n_used
        self.b = len(traces)
        self.num_fns = traces[0].num_fns
        self.idle = np.asarray(idle_watts, float)
        self.orig_duration = max(t.duration for t in traces)
        capping = cfg.capping or CappingConfig(
            power_cap_watts=cfg.cap_watts,
            control_interval_s=delta,
            use_footprints=cfg.use_footprints,
        )
        self.fleet = FleetPowerCapController(capping, self.b)
        self.meter = LivePriceMeter(self.num_fns, cfg.pricing)
        self.scheduler = EnergyAwareScheduler(
            SchedulerConfig(capping=capping),
            executor=lambda inv: inv.payload["dur"],
            footprint_of=self._footprint_of,
            mean_latency_of=lambda fn: self.registry[fn].mean_latency_s,
        )
        # Fleet-wide arrival stream, start-ordered (numpy, no Python loop
        # over 1e5 invocations).
        fns, starts, durs, nodes = [], [], [], []
        for i, tr in enumerate(traces):
            valid = tr.fn_id >= 0
            fns.append(tr.fn_id[valid].astype(np.int64))
            starts.append(tr.start[valid].astype(np.float64))
            durs.append((tr.end - tr.start)[valid].astype(np.float64))
            nodes.append(np.full(int(valid.sum()), i, np.int64))
        fns = np.concatenate(fns) if fns else np.zeros(0, np.int64)
        starts = np.concatenate(starts) if fns.size else np.zeros(0)
        durs = np.concatenate(durs) if fns.size else np.zeros(0)
        nodes = np.concatenate(nodes) if fns.size else np.zeros(0, np.int64)
        order = np.argsort(starts, kind="stable")
        self._arr_fn = fns[order]
        self._arr_t = starts[order]
        self._arr_dur = durs[order]
        self._arr_node = nodes[order]
        # Controlled schedule under construction: per node [(fn, start, dur)].
        self._controlled: list[list[tuple[int, float, float]]] = [
            [] for _ in range(self.b)
        ]
        # Power the loop itself moved into future windows: re-injected
        # deferred (or migrated) invocations run where the observed baseline
        # telemetry has no trace of them, so the controller must charge
        # itself for them or it over-admits on top of its own shifted load.
        # Entries are (node, end_t, nameplate watts).
        self._shifted: list[tuple[int, float, float]] = []
        self._nameplate = np.asarray(
            [s.dyn_power_w for s in registry.specs], float
        )
        # Pass the init segment through verbatim (bulk slice: the stream is
        # start-sorted, so the init prefix is one searchsorted).
        init_end = init_n * delta
        self._cursor = 0
        self._passthrough(int(np.searchsorted(self._arr_t, init_end, side="left")))

    def _passthrough(self, k1: int) -> None:
        """Record arrivals [cursor, k1) into the controlled schedule
        verbatim (no admission control) and advance the cursor."""
        k0 = self._cursor
        if k1 <= k0:
            return
        rows = zip(
            self._arr_node[k0:k1].tolist(),
            self._arr_fn[k0:k1].tolist(),
            self._arr_t[k0:k1].tolist(),
            self._arr_dur[k0:k1].tolist(),
        )
        for node, fn, t, dur in rows:
            self._controlled[node].append((fn, t, dur))
        self._cursor = k1

    def attach_session(self, session) -> None:
        """Give the loop the live ``StreamingFleetSession`` (retrain/resync
        act on it); called by ``profile_fleet`` once the session exists."""
        self.session = session

    # -- live footprints ----------------------------------------------------

    def _footprint_of(self, fn_name: str) -> float | None:
        """Fleet-mean live per-invocation footprint J_lambda (J), or None
        before any node has metered an invocation of this function."""
        j = self.registry.index[fn_name]
        vals = [
            tr.per_invocation_indiv[j]
            for tr in self.trackers
            if tr is not None and tr.invocations[j] > 0
        ]
        return float(np.mean(vals)) if vals else None

    # -- the tick hook -------------------------------------------------------

    def on_tick(self, tk, trackers) -> None:
        """One control round: observe -> bill -> admit/place -> maintain."""
        if not self._bound:
            raise ValueError("ControlLoop.on_tick before bind()")
        cfg = self.config
        self.ticks_seen += 1
        now = tk.t * self.delta
        live = tk.valid
        # (1) capping observes each node's sensed power, plus the load the
        # loop itself shifted into this window (deferred work re-injected
        # later than the baseline ran it — invisible to the observed
        # telemetry, so it is charged at nameplate on top).
        self._shifted = [(n, e, p) for (n, e, p) in self._shifted if e > now]
        shifted = np.zeros(self.b)
        for n, _, p in self._shifted:
            shifted[n] += p
        self.fleet.observe_power(np.asarray(tk.w_sys, float) + shifted, valid=live)
        # (2) pricing folds the conserved per-tick attribution in.
        for i in range(self.b):
            if live is None or live[i]:
                self.meter.observe_tick(
                    tk.tick_power[i], tk.a[i], self.delta, idle_watts=self.idle[i]
                )
        # (3) admission + placement for this window's arrivals.  The stream
        # is start-sorted, so this window's slice is one searchsorted — the
        # per-arrival Python scan over the cursor scaled as O(ticks + N)
        # comparisons *inside the tick hook*; the bulk build keeps the hot
        # path a few numpy calls.  Submission order (arrival order) is
        # preserved, so admission decisions are exactly the loop's.
        wend = now + self.delta
        names = self.registry.names
        k0 = self._cursor
        k1 = int(np.searchsorted(self._arr_t, wend, side="left"))
        if k1 > k0:
            arr_fn = self._arr_fn[k0:k1].tolist()
            arr_t = self._arr_t[k0:k1].tolist()
            arr_dur = self._arr_dur[k0:k1].tolist()
            arr_node = self._arr_node[k0:k1].tolist()
            for fn, t, dur, node in zip(arr_fn, arr_t, arr_dur, arr_node):
                self.scheduler.submit(
                    Invocation(
                        function=names[fn],
                        arrival=t,
                        payload={"node": node, "dur": dur, "fn": fn},
                    )
                )
            self._cursor = k1
        placed = self.scheduler.drain_fleet(
            now, fleet=self.fleet, placement=cfg.placement, live=live
        )
        for inv, node in placed:
            fn = inv.payload["fn"]
            self._controlled[node].append(
                (fn, float(inv.started_at), inv.payload["dur"])
            )
            # A deferred restart (or a migration) runs power the baseline
            # telemetry never saw on this node: self-charge it.
            if inv.started_at > inv.arrival + 1e-9 or node != inv.payload["node"]:
                self._shifted.append(
                    (
                        node,
                        float(inv.started_at) + inv.payload["dur"],
                        float(self._nameplate[fn]),
                    )
                )
        # (4) model maintenance at step boundaries.
        if tk.step_completed and self.session is not None:
            if cfg.retrain and bool(self.session.retrain_needed.any()):
                flags = self.session.refit_counter_models(
                    self.session.retrain_needed,
                    window_steps=cfg.retrain_window_steps,
                )
                if flags.any():
                    self.retrain_events.append((tk.t, flags))
            if cfg.resync_every_steps:
                steps = len(self.session.model_errors) or (
                    (tk.t + 1 - self.init_n) // self.session.cfg.step_windows
                )
                if steps and steps % cfg.resync_every_steps == 0:
                    self.session.resync()
                    self.resync_events.append(tk.t)

    # -- completion ----------------------------------------------------------

    def finish(self) -> None:
        """Close the loop after the replay: pass the post-engine tail
        through verbatim, then drain the still-deferred queue past the
        segment end with footprint-aware packing — windows are filled up to
        the cap using each invocation's predicted power (J_lambda / tau),
        advancing one control window at a time, so the deferred work lands
        as a cap-respecting tail instead of one spike."""
        if self._finished:
            return
        self._finished = True
        cfg = self.config
        # Tail arrivals the engine never saw: uncontrolled passthrough.
        self._passthrough(self._arr_t.size)
        # Deferred leftovers: predictive packing after the last real window.
        last = max(
            [self.n_used * self.delta]
            + [s + 0.0 for node in self._controlled for (_, s, _) in node[-1:]]
        )
        w = int(np.ceil(max(last, self.orig_duration) / self.delta))
        # Seed the packer with everything already scheduled that is still
        # running at the first drain window (live-region admissions whose
        # durations cross the segment boundary) — an empty start would let
        # the packer stack drained work on top of them.
        running: list[tuple[int, float, float]] = [  # (node, end_t, watts)
            (i, s + d, float(self._nameplate[fn]))
            for i, node in enumerate(self._controlled)
            for (fn, s, d) in node
            if s + d > w * self.delta
        ]
        specs = self.registry.specs
        pack_cap = cfg.cap_watts * (1.0 - cfg.drain_margin)
        while self.scheduler.queue:
            inv = self.scheduler.queue.popleft()
            fn = inv.payload["fn"]
            dur = max(inv.payload["dur"], 1e-3)
            j = self._footprint_of(inv.function)
            # Measured footprints are *attributed* watts — at high
            # concurrency the host's sublinear power curve compresses each
            # invocation's share, so J_lambda / tau under-predicts what the
            # same invocation draws in the (less concurrent) drain tail.
            # Pack against the larger of the measured rate and the
            # registry's nameplate dynamic power: conservative in either
            # direction, so drain windows land under the cap.
            watts = max(
                (j / dur) if j is not None else 0.0, specs[fn].dyn_power_w
            )
            while True:
                now = w * self.delta
                running = [r for r in running if r[1] > now]
                loads = self.idle.copy()
                for node, _, p in running:
                    loads[node] += p
                # No-migration mode drains each leftover on its origin node.
                order = (
                    np.argsort(loads, kind="stable")
                    if cfg.placement
                    else [inv.payload["node"]]
                )
                placed = False
                for i in order:
                    i = int(i)
                    # An idle node always admits (termination + conservation:
                    # deferred work must run even if one invocation alone
                    # exceeds the cap).
                    if loads[i] + watts <= pack_cap or loads[i] <= self.idle[i] + 1e-9:
                        self._controlled[i].append((fn, now, dur))
                        running.append((i, now + dur, watts))
                        self.drain_waits.append(now - inv.arrival)
                        placed = True
                        break
                if placed:
                    break
                w += 1

    def controlled_traces(self) -> list[InvocationTrace]:
        """The reshaped per-node traces: every original invocation, same
        durations, starts moved by admission control.  Re-simulate these to
        measure what the control actually did to power."""
        if not self._finished:
            raise ValueError("controlled_traces needs finish() (profile_fleet calls it)")
        end_max = self.orig_duration
        for node in self._controlled:
            for _, s, d in node:
                end_max = max(end_max, s + d)
        duration = float(np.ceil(end_max / self.delta) * self.delta)
        names = self.registry.names
        out = []
        for node in self._controlled:
            if node:
                fn = np.asarray([e[0] for e in node], np.int32)
                st = np.asarray([e[1] for e in node], np.float64)
                du = np.asarray([e[2] for e in node], np.float64)
            else:
                fn = np.zeros(0, np.int32)
                st = np.zeros(0)
                du = np.zeros(0)
            order = np.argsort(st, kind="stable")
            out.append(
                InvocationTrace(
                    fn_id=fn[order],
                    start=st[order].astype(np.float32),
                    end=(st + du)[order].astype(np.float32),
                    num_fns=self.num_fns,
                    duration=duration,
                    fn_names=names,
                )
            )
        return out

    def summary(self) -> dict:
        """Scalar outcome metrics: capping, deferral cost, maintenance."""
        stats = self.fleet.stats
        waits = np.asarray(self.scheduler.stats.queue_waits + self.drain_waits)
        return {
            "ticks": self.ticks_seen,
            "observed_overshoot_fraction": stats.overshoot_fraction,
            "admitted": stats.admitted,
            "deferred_decisions": stats.deferred,
            "deferred_by_cap": self.scheduler.stats.deferred_by_cap,
            "mean_queue_wait_s": float(waits.mean()) if waits.size else 0.0,
            "max_queue_wait_s": float(waits.max()) if waits.size else 0.0,
            "billed_joules": float(np.sum(self.meter.j_total)),
            "retrain_events": len(self.retrain_events),
            "resync_events": len(self.resync_events),
        }


class EnergyFirstControlPlane:
    """Energy-first control plane over a function registry, profiling on
    ``device`` (default the card; raises there without CUDA)."""

    def __init__(
        self,
        registry: FunctionRegistry,
        sim_config: SimulatorConfig = SimulatorConfig(),
        profiler_config: ProfilerConfig = ProfilerConfig(),
        pricing_config: PricingConfig = PricingConfig(),
        *,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.registry = registry
        self.simulator = NodeSimulator(registry, sim_config)
        self.profiler = FaasMeterProfiler(profiler_config)
        self.pricing = pricing_config

    def _prices(self, report: FootprintReport) -> dict:
        mem = torch.tensor([s.mem_gb for s in self.registry.specs], dtype=torch.float32, device=self.device)
        return price_report(
            report.spectrum.j_indiv, report.spectrum.j_total, report.invocations,
            report.mean_latency, mem, self.pricing,
        )

    # -- profiling ---------------------------------------------------------

    def profile_trace(self, trace: InvocationTrace, *, seed: int | None = None) -> ProfiledWorkload:
        """Simulate one node's telemetry for ``trace``, profile it, price it."""
        sim = self.simulator.simulate(trace, seed=seed)
        report = self.profiler.profile(
            trace.fn_id, trace.start, trace.end,
            num_fns=trace.num_fns, duration=trace.duration,
            telemetry=sim.telemetry, device=self.device,
        )
        return ProfiledWorkload(report=report, sim=sim, trace=trace, prices=self._prices(report))

    def combined_counter_inputs(
        self,
        profiler: FaasMeterProfiler,
        trace_arrays,
        telemetries,
        *,
        num_fns: int,
        duration,
    ):
        """Counter features + per-node ridge models for combined mode (§4.3).

        Derives the (M,) step-counter specs (gflops/hbm/mean latency) from
        the registry and delegates to ``core.profiler.prepare_combined_fleet``
        — models are fit on each node's N_init block of chip power, so the
        same inputs drive the batch, streaming and per-node paths
        identically.  Returns ``(fn_counters, window_features, models)``.
        """
        specs = self.registry.specs
        return prepare_combined_fleet(
            profiler.config, trace_arrays, telemetries,
            num_fns=num_fns, duration=duration,
            gflops=np.asarray([s.gflops for s in specs]),
            hbm_gb=np.asarray([s.hbm_gb for s in specs]),
            mean_latency=np.asarray([max(s.mean_latency_s, 1e-3) for s in specs]),
            device=self.device,
        )

    def profile_fleet(
        self,
        traces: list[InvocationTrace],
        *,
        seeds: list[int] | None = None,
        platforms: list[str] | None = None,
        on_tick=None,
        mesh="auto",
        slots: int | None = None,
        mode: str | None = None,
        prefetch: int = 2,
        drain: bool = False,
        control=None,
        tick_transform=None,
    ) -> list[ProfiledWorkload]:
        """Profile many nodes through the *streaming* fleet engine, live.

        One vectorized simulation pass generates every node's power traces;
        the telemetry is then replayed into a ``StreamingFleetSession`` one
        delta-window at a time, as a live collection pipeline would deliver
        it.  Each engine tick feeds every node's
        ``StreamingFootprintTracker`` (``observe_tick``), then the bound
        ``control`` loop, then ``on_tick(stream_tick, trackers)``.

        Falls back to the per-node path (no trackers) when the segment is
        too short for a single Kalman step, or when some node cannot cover
        the common N_init window.  Ragged fleets (traces of different
        ``duration``) stream as one batch: ended nodes are masked out, their
        trackers stop accumulating, and each report covers its own span.

        Args:
          traces: per-node invocation traces (equal num_fns).
          seeds: optional per-node simulator seeds.
          platforms: optional per-node platform names
            (``"server"``/``"desktop"``/``"edge"``): a mixed fleet runs as
            one batch.
          on_tick: optional hook ``(StreamTick, trackers) -> None``.
          mesh: ``"auto"`` resolves to the single-device path (node-axis
            meshes are not ported); ``None`` is the same; an explicit mesh
            raises ``NotImplementedError``.
          slots: not ported yet, raises ``NotImplementedError`` (ROADMAP
            Queue 1 item 8).
          mode: ``"pure"`` | ``"combined"`` (§4.3) — defaults to the
            profiler config's mode.  Combined needs chip telemetry on at
            least one node; per-node counter models are fit on the N_init
            block (``combined_counter_inputs``), the engine disaggregates
            the chip-subtracted 'rest' power, live trackers are fed the
            full X = X_CPU + X_Rest, and retrain flags are checked at every
            Kalman step (``session.retrain_needed``).  Chipless nodes ride
            the same batch as data: zero chip series, zero model, so their
            rows are exactly the pure ones.
          prefetch: ingest lookahead in windows (``0`` = strict
            alternation of sensing and dispatch).
          drain: run the emit stage (numpy materialization, retrain checks,
            tracker feeds, the control loop, ``on_tick``) on a background
            drain thread; bitwise identical results.
          control: optional ``ControlLoop`` — the closed-loop controller,
            bound to this replay (arrival stream, trackers, idle floors),
            hooked into the tick path after the trackers and before
            ``on_tick``, and finished after ``finalize`` (its
            ``controlled_traces()`` then hold the reshaped schedule).
            Needs the streaming path: a segment too short to stream raises.
          tick_transform: optional ``iterator -> iterator`` over the
            ``FleetTelemetryTick`` stream, applied before ingest (the
            fault/drift injection hook, e.g.
            ``telemetry.simulator.chip_drift_transform``).

        Returns:
          One ``ProfiledWorkload`` per node, with ``footprint_stream``
          holding the live-fed tracker (None on the fallback).
        """
        if isinstance(mesh, str) and mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None, or a FleetMesh; got {mesh!r}")
        if mesh is not None and mesh != "auto":
            raise NotImplementedError(_NO_MESH)
        if slots is not None:
            raise NotImplementedError(_NO_SLOTS)
        cfg = self.profiler.config
        mode = cfg.mode if mode is None else mode
        if mode not in ("pure", "combined"):
            raise ValueError(f"mode must be 'pure' or 'combined'; got {mode!r}")
        if not traces:
            return []
        profiler = (
            self.profiler
            if mode == cfg.mode
            else FaasMeterProfiler(dataclasses.replace(cfg, mode=mode))
        )
        cfg = profiler.config
        combined = mode == "combined"
        sims = self.simulator.simulate_fleet(traces, seeds, platforms=platforms)
        durations = [t.duration for t in traces]
        ragged = len(set(durations)) > 1
        duration = durations if ragged else durations[0]
        num_fns = traces[0].num_fns
        trace_arrays = [(t.fn_id, t.start, t.end) for t in traces]
        tels = [s.telemetry for s in sims]
        has_chip = [tel.chip_power is not None for tel in tels]
        if combined and not any(has_chip):
            raise ValueError(
                "profile_fleet(mode='combined') needs a chip power source "
                "on at least one node (no platform here has one — use pure "
                "mode)"
            )
        plans = [segment_plan(cfg, d) for d in durations]
        n_max = max(p[0] for p in plans)
        s = max(p[2] for p in plans)
        init_uniform = len({p[1] for p in plans}) == 1
        has_cp_flags = [
            cfg.account_control_plane and tel.cp_cpu_frac is not None for tel in tels
        ]
        if len(set(has_cp_flags)) > 1:
            raise ValueError(
                "profile_fleet needs a homogeneous fleet: telemetries mix "
                "present/absent cp_cpu_frac (use fleet_profile instead)"
            )
        fn_counters = window_feats = counter_model = None
        if combined and init_uniform:
            fn_counters, window_feats, counter_model = self.combined_counter_inputs(
                profiler, trace_arrays, tels, num_fns=num_fns, duration=duration
            )

        if s == 0 or not init_uniform:
            # No streaming state to track: an attached-but-never-fed tracker
            # would report 0 J/invocation as if it were a measurement.
            if control is not None:
                raise ValueError(
                    "profile_fleet(control=...) needs the streaming path: "
                    "the segment is too short for a Kalman step (or nodes "
                    "cannot cover a common N_init window), so there is no "
                    "tick stream to drive the control loop"
                )
            if combined and not init_uniform:
                raise ValueError(
                    "profile_fleet(mode='combined') needs every node to "
                    "cover the common N_init window (counter models are "
                    "fit on it); use the per-node path"
                )
            reports = fleet_profile(
                profiler, trace_arrays, tels, num_fns=num_fns, duration=duration,
                fn_counters=fn_counters, counter_model=counter_model, device=self.device,
            )
            trackers: list[StreamingFootprintTracker | None] = [None] * len(traces)
        else:
            trackers = [
                StreamingFootprintTracker(num_fns, idle_watts=tel.idle_watts) for tel in tels
            ]
            if control is not None:
                control.bind(
                    traces=traces, registry=self.registry, trackers=trackers,
                    idle_watts=[tel.idle_watts for tel in tels],
                    delta=cfg.delta, init_n=plans[0][1],
                    n_used=plans[0][1] + s * cfg.step_windows,
                )

            # Combined mode: live trackers meter the full spectrum — the
            # causal rest estimate plus the node's X_CPU.  X_CPU is static
            # per segment until a live refit rewrites it (ControlLoop
            # retrain), so its host copy is re-read whenever the session's
            # refit count moves.
            x_cpu_host = {"refits": -1, "v": None}

            def _full_x(x_rest):
                if not combined:
                    return x_rest
                n = len(session.refits)
                if x_cpu_host["refits"] != n:
                    x_cpu_host["v"] = session.x_cpu.cpu().numpy()
                    x_cpu_host["refits"] = n
                return x_rest[:, :num_fns] + x_cpu_host["v"]

            def _on_bootstrap(sess):
                # Seed with the init segment (X_0 estimate) so functions
                # active only early still carry their energy.
                x0 = _full_x(sess.x0.cpu().numpy())
                busy = sess.init_busy_seconds.cpu().numpy()
                inv = sess.init_invocations.cpu().numpy()
                for i, tr in enumerate(trackers):
                    tr.observe_step(x0[i], busy[i], inv[i], sess.init_seconds)

            def _on_tick(tk):
                x = _full_x(tk.x)
                for i, tr in enumerate(trackers):
                    # A node whose stream has ended stops accumulating.
                    if tk.valid is None or tk.valid[i]:
                        tr.observe_tick(x[i], tk.busy_seconds[i], tk.a[i], cfg.delta)
                if control is not None:
                    control.on_tick(tk, trackers)
                if on_tick is not None:
                    on_tick(tk, trackers)

            session = profiler.start_fleet_stream(
                trace_arrays, num_fns=num_fns, duration=duration,
                idle_watts=[tel.idle_watts for tel in tels],
                has_chip=has_chip, has_cp=has_cp_flags[0],
                on_tick=_on_tick, on_bootstrap=_on_bootstrap,
                fn_counters=fn_counters, counter_model=counter_model,
                window_features=window_feats, device=self.device,
            )

            # Stack each signal once into (N_max, B) so the tick generator
            # indexes rows; shorter nodes are zero-padded (the session masks
            # their dead ticks out of the engine anyway).
            def _stack(get):
                arr = np.zeros((n_max, len(tels)), np.float32)
                for i, tel in enumerate(tels):
                    col = get(tel)
                    if col is None:
                        continue  # chipless node: zero column, as data
                    col = np.asarray(col)
                    arr[: col.shape[0], i] = col
                return arr

            sys_np = _stack(lambda tel: tel.system_power)
            chip_np = _stack(lambda tel: tel.chip_power) if any(has_chip) else None
            cp_np = _stack(lambda tel: tel.cp_cpu_frac) if has_cp_flags[0] else None
            sf_np = _stack(lambda tel: tel.sys_cpu_frac) if has_cp_flags[0] else None

            def _ticks():
                for t in range(n_max):
                    yield FleetTelemetryTick(
                        t=t,
                        w_sys=sys_np[t],
                        w_chip=chip_np[t] if chip_np is not None else None,
                        cp_frac=cp_np[t] if cp_np is not None else None,
                        sys_frac=sf_np[t] if sf_np is not None else None,
                    )

            if control is not None:
                control.attach_session(session)
            ticks = _ticks()
            if tick_transform is not None:
                ticks = tick_transform(ticks)
            session.ingest(ticks, prefetch=prefetch, drain=drain)
            reports = session.finalize()
            if control is not None:
                control.finish()

        return [
            ProfiledWorkload(
                report=report, sim=sim, trace=trace, prices=self._prices(report),
                footprint_stream=tracker,
            )
            for trace, sim, report, tracker in zip(traces, sims, reports, trackers)
        ]

    def marginal_energy(self, trace: InvocationTrace, fn: int, *, seed: int | None = None) -> float:
        """Paper Eq. 6 ground truth via the measured (coarse) energy totals."""
        return self.simulator.marginal_energy(trace, fn, seed=seed)

    # -- software power capping (Fig. 10) -----------------------------------

    def run_capped(
        self,
        trace: InvocationTrace,
        cap_watts: float,
        *,
        footprints: np.ndarray | None = None,
        control_dt: float = 0.25,
        use_footprints: bool = True,
    ) -> "CapRunResult":
        """Discrete-event execution of ``trace`` under a power cap.

        Invocations arrive at their trace start times; a deferred invocation
        keeps its *duration* but starts late (queue wait), exactly like the
        paper's queue-based software capping.
        """
        cfg = self.simulator.power_cfg
        model = self.simulator.model
        order = np.argsort(trace.start, kind="stable")
        valid = trace.fn_id[order] >= 0
        arr_fn = trace.fn_id[order][valid]
        arr_t = trace.start[order][valid]
        durs = (trace.end - trace.start)[order][valid]

        ctl = PowerCapController(
            CappingConfig(
                power_cap_watts=cap_watts,
                control_interval_s=control_dt,
                use_footprints=use_footprints,
            )
        )
        if footprints is None:
            footprints = np.asarray(
                [s.dyn_power_w * s.mean_latency_s for s in self.registry.specs]
            )
        # The controller knows class-mean latencies (FaasMeter telemetry),
        # never an invocation's realized duration.
        mean_lat = np.asarray([s.mean_latency_s for s in self.registry.specs])
        # Admission floor: at delta = 1 s windows, sub-window functions'
        # per-class power is under-resolved, but the AGGREGATE active power
        # is pinned by the efficiency property (sum C X ~ W - idle).  Floor
        # every class's admission increment at the fleet-average active
        # power X_bar = sum(J_i A_i) / sum(tau_i A_i) — conservative for
        # short functions, exact in aggregate.
        inv_counts = np.asarray(
            [max((trace.fn_id == j).sum(), 0) for j in range(trace.num_fns)], float
        )
        busy = float(np.sum(mean_lat * inv_counts))
        xbar = float(np.sum(footprints * inv_counts)) / max(busy, 1e-9)
        adm_footprints = np.maximum(footprints, xbar * mean_lat)

        n_steps = int(np.ceil(trace.duration / control_dt)) + 1
        running: list[tuple[int, float]] = []  # (fn, end_time)
        queue: deque[tuple[int, float, float]] = deque()  # (fn, dur, arrival)
        next_arrival = 0
        power_series = np.zeros(n_steps)
        new_start = np.full(arr_fn.shape, np.nan)
        new_fn = arr_fn.copy()
        new_dur = durs.copy()
        started = 0
        idx_of_started: list[int] = []

        for step in range(n_steps):
            now = step * control_dt
            # arrivals
            while next_arrival < len(arr_t) and arr_t[next_arrival] <= now:
                queue.append((arr_fn[next_arrival], durs[next_arrival], arr_t[next_arrival]))
                idx_of_started.append(next_arrival)
                next_arrival += 1
            # completions
            running = [(f, e) for (f, e) in running if e > now]
            # current power
            act = np.zeros(trace.num_fns)
            for f, _ in running:
                act[f] += 1.0
            p_dyn = float(model._compress(act @ model.dyn_power_w))
            watts = cfg.idle_w + p_dyn + cfg.cp_base_w
            power_series[step] = watts
            ctl.observe_power(watts)
            # admissions (head-of-queue, footprint-aware)
            while queue:
                f, dur, arr = queue[0]
                j = float(adm_footprints[f]) if use_footprints else None
                if not ctl.admit(j, duration_s=float(mean_lat[f])):
                    break
                queue.popleft()
                running.append((f, now + dur))
                # find the original slot for this (fn, arrival) pair
                k = started
                new_start[k] = now
                new_fn[k] = f
                new_dur[k] = dur
                started += 1
        # anything never started runs at the end (drain)
        for f, dur, arr in queue:
            new_start[started] = trace.duration
            new_fn[started] = f
            new_dur[started] = dur
            started += 1

        waits = new_start[:started] - arr_t[:started]
        return CapRunResult(
            power_series=power_series,
            control_dt=control_dt,
            cap_watts=cap_watts,
            stats=ctl.stats,
            queue_waits=np.maximum(waits, 0.0),
            latencies=new_dur[:started] + np.maximum(waits, 0.0),
        )


@dataclasses.dataclass
class CapRunResult:
    """Outcome of one capped discrete-event run (``run_capped``): the
    control-interval power series plus queue-wait/latency distributions."""

    power_series: np.ndarray
    control_dt: float
    cap_watts: float
    stats: object
    queue_waits: np.ndarray
    latencies: np.ndarray

    @property
    def overshoot_fraction(self) -> float:
        return float(np.mean(self.power_series > self.cap_watts))

    @property
    def mean_overshoot_magnitude(self) -> float:
        over = np.maximum(self.power_series - self.cap_watts, 0.0) / self.cap_watts
        violating = over[over > 0]
        return float(violating.mean()) if violating.size else 0.0


class MeteredServer:
    """Serve real models and meter them through FaasMeter.

    Each registered (name, engine, batch) is a FaaS function class; ``serve``
    executes a request schedule and collects the *measured* invocation
    trace, which the caller profiles -- the energy-first serving path on
    live compute.  (The reference's unused ``profiler_config`` argument is
    dropped.)
    """

    def __init__(self):
        self.functions: dict[str, tuple] = {}
        self.order: list[str] = []

    def register(self, name: str, engine, batch: dict, *, steps: int = 4) -> None:
        self.functions[name] = (engine, batch, steps)
        self.order.append(name)

    def serve(self, schedule: list[tuple[str, float]], duration: float) -> InvocationTrace:
        """Run (function, at_time) requests back-to-back; wall-clock metered.

        Returns an InvocationTrace in *relative* time with real latencies.
        A function's first request starts it cold (``warmup``), outside the
        metered span.
        """
        t_base = time.perf_counter()
        fn_ids, starts, ends = [], [], []
        for name, _at in schedule:
            engine, batch, steps = self.functions[name]
            if engine.cold:
                engine.warmup(batch)  # cold start, not metered as warm
            t0 = time.perf_counter() - t_base
            engine.generate(batch, steps)
            t1 = time.perf_counter() - t_base
            fn_ids.append(self.order.index(name))
            starts.append(t0)
            ends.append(t1)
        total = max(duration, (ends[-1] if ends else 0.0) + 1.0)
        return InvocationTrace(
            fn_id=np.asarray(fn_ids, np.int32),
            start=np.asarray(starts, np.float32),
            end=np.asarray(ends, np.float32),
            num_fns=len(self.order),
            duration=float(np.ceil(total)),
            fn_names=list(self.order),
        )
