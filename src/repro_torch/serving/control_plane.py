"""Energy-first FaaS control plane (paper Fig. 1, §5, §6.3) -- the port of
the reference's ``repro/serving/control_plane.py``.

Ties together workload -> telemetry -> FaasMeter profiling -> footprints ->
pricing:

- ``EnergyFirstControlPlane.profile_trace``: trace-driven, one node.
- ``EnergyFirstControlPlane.profile_fleet``: the *streaming* fleet path —
  telemetry is fed window-by-window into a ``StreamingFleetSession``, each
  engine tick updates every node's ``StreamingFootprintTracker`` live, and
  the ``on_tick`` hook sees conserved per-tick attribution.
- ``MeteredServer`` (real-exec): actual model invocations on this host,
  timed and traced for metering.

Not yet ported (ROADMAP Queue 1): combined mode (item 6), the closed
control loop ``ControlLoop``, ``run_capped`` and the fleet power-cap
controller (item 7), and slot pools and node-axis meshes (item 8).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine.segment import _NO_MESH
from repro_torch.core.pricing import PricingConfig, price_report
from repro_torch.core.profiler import (
    FaasMeterProfiler,
    FootprintReport,
    ProfilerConfig,
    fleet_profile,
    segment_plan,
)
from repro_torch.core.sessions.base import _NO_COMBINED, _NO_SLOTS
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.telemetry.simulator import (
    FleetTelemetryTick,
    NodeSimulator,
    SimResult,
    SimulatorConfig,
)
from repro_torch.workload.functions import FunctionRegistry
from repro_torch.workload.trace import InvocationTrace

_NO_CONTROL = (
    "control= (the closed energy-control loop, ControlLoop) is not ported "
    "yet: ROADMAP Queue 1 item 7"
)


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
        ``StreamingFootprintTracker`` (``observe_tick``) and then calls
        ``on_tick(stream_tick, trackers)``.

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
          slots, mode="combined", control: not ported yet, raise
            ``NotImplementedError`` (ROADMAP Queue 1 items 6-8).
          prefetch: ingest lookahead in windows (``0`` = strict
            alternation of sensing and dispatch).
          drain: run the emit stage (numpy materialization, tracker feeds,
            ``on_tick``) on a background drain thread; bitwise identical
            results.
          tick_transform: optional ``iterator -> iterator`` over the
            ``FleetTelemetryTick`` stream, applied before ingest.

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
        if control is not None:
            raise NotImplementedError(_NO_CONTROL)
        cfg = self.profiler.config
        mode = cfg.mode if mode is None else mode
        if mode == "combined":
            raise NotImplementedError(_NO_COMBINED)
        if mode != "pure":
            raise ValueError(f"mode must be 'pure' or 'combined'; got {mode!r}")
        if not traces:
            return []
        sims = self.simulator.simulate_fleet(traces, seeds, platforms=platforms)
        durations = [t.duration for t in traces]
        ragged = len(set(durations)) > 1
        duration = durations if ragged else durations[0]
        num_fns = traces[0].num_fns
        trace_arrays = [(t.fn_id, t.start, t.end) for t in traces]
        tels = [s.telemetry for s in sims]
        has_chip = [tel.chip_power is not None for tel in tels]
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

        if s == 0 or not init_uniform:
            # No streaming state to track: an attached-but-never-fed tracker
            # would report 0 J/invocation as if it were a measurement.
            reports = fleet_profile(
                self.profiler, trace_arrays, tels, num_fns=num_fns, duration=duration,
                device=self.device,
            )
            trackers: list[StreamingFootprintTracker | None] = [None] * len(traces)
        else:
            trackers = [
                StreamingFootprintTracker(num_fns, idle_watts=tel.idle_watts) for tel in tels
            ]

            def _on_bootstrap(sess):
                # Seed with the init segment (X_0 estimate) so functions
                # active only early still carry their energy.
                x0 = sess.x0.cpu().numpy()
                busy = sess.init_busy_seconds.cpu().numpy()
                inv = sess.init_invocations.cpu().numpy()
                for i, tr in enumerate(trackers):
                    tr.observe_step(x0[i], busy[i], inv[i], sess.init_seconds)

            def _on_tick(tk):
                for i, tr in enumerate(trackers):
                    # A node whose stream has ended stops accumulating.
                    if tk.valid is None or tk.valid[i]:
                        tr.observe_tick(tk.x[i], tk.busy_seconds[i], tk.a[i], cfg.delta)
                if on_tick is not None:
                    on_tick(tk, trackers)

            session = self.profiler.start_fleet_stream(
                trace_arrays, num_fns=num_fns, duration=duration,
                idle_watts=[tel.idle_watts for tel in tels],
                has_chip=has_chip, has_cp=has_cp_flags[0],
                on_tick=_on_tick, on_bootstrap=_on_bootstrap, device=self.device,
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

            ticks = _ticks()
            if tick_transform is not None:
                ticks = tick_transform(ticks)
            session.ingest(ticks, prefetch=prefetch, drain=drain)
            reports = session.finalize()

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
