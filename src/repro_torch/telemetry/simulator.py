"""Node telemetry simulator: the measurement platform stand-in (paper §6).

Wires trace -> activity -> true power -> sensor front-ends -> window-grid
telemetry for the profiler.  Ground truth (true power series, per-function
true energies) stays on the SimResult for *validation only* — the profiler
consumes only the degraded, lagged, quantized signals.

Platform presets mirror the paper's three:

- ``server``:  idle 95 W, IPMI-like system source (1 Hz, laggy, 4 W quant)
- ``desktop``: idle 15 W, plug-like system source (4 Hz, clean)
- ``edge``:    idle 8 W, tegrastats-like (2 Hz), no RAPL-like chip source
  (pure-disaggregation mode only, like the Jetson in the paper)
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.core.profiler import Telemetry
from repro_torch.telemetry import sources as src
from repro_torch.telemetry.power_model import (
    FleetPowerModel,
    NodePowerModel,
    PowerModelConfig,
)
from repro_torch.workload.functions import FunctionRegistry
from repro_torch.workload.trace import InvocationTrace


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    dt: float = 0.02                  # fine simulation grid (s)
    delta: float = 1.0                # profiler window (s)
    platform: str = "server"          # server | desktop | edge
    system_sensor: src.SensorConfig | None = None   # override preset
    chip_sensor: src.SensorConfig | None = src.RAPL_LIKE
    power: PowerModelConfig | None = None
    seed: int = 0


_PLATFORMS = {
    "server": dict(idle_w=95.0, chip_idle_w=40.0, sensor=src.IPMI_LIKE, has_chip=True),
    "desktop": dict(idle_w=15.0, chip_idle_w=6.0, sensor=src.PLUG_LIKE, has_chip=True),
    "edge": dict(
        idle_w=8.0,
        chip_idle_w=3.0,
        sensor=src.SensorConfig(rate_hz=2.0, tau_s=0.5, lag_s=1.0, noise_w=0.4, quant_w=0.25),
        has_chip=False,
    ),
}


@dataclasses.dataclass
class SimResult:
    telemetry: Telemetry               # window-grid inputs for the profiler
    num_windows: int
    measured_energy_j: float           # integral of the *sensed* system signal
    true_energy_j: float               # integral of the true series (oracle)
    true_fn_energy_j: np.ndarray       # (M,) oracle dynamic energy per function
    true_fn_power_w: np.ndarray        # (M,) oracle dynamic power while running
    true_cp_energy_j: float
    system_signal: src.PowerSignal     # raw sensed signals (fig benchmarks)
    chip_signal: src.PowerSignal | None
    activity: np.ndarray               # (T, M) fine-grid concurrency
    fine_dt: float


class FleetTelemetryTick(NamedTuple):
    """One delta-window of live fleet telemetry (all arrays shaped (B,)).

    Yielded by ``NodeSimulator.stream_fleet`` in window order; the streaming
    profiler session (``core.profiler.StreamingFleetSession``) consumes these
    one at a time.  On a ragged fleet (per-node durations) ``valid`` marks
    which nodes really produced window ``t``; ended nodes carry zeros in the
    value arrays and must be ignored downstream (the profiler session masks
    them out of the engine via ``FleetStep.valid``).
    """

    t: int                      # window index
    w_sys: np.ndarray           # (B,) sensed system power (W)
    w_chip: np.ndarray | None   # (B,) sensed chip power, None without chip sensor
    cp_frac: np.ndarray         # (B,) control-plane CPU fraction
    sys_frac: np.ndarray        # (B,) system-wide CPU fraction
    valid: np.ndarray | None = None  # (B,) bool node liveness; None = all live


def chip_drift_transform(factor: float, after_t: int):
    """Build a ``profile_fleet(tick_transform=...)`` hook that scales every
    node's sensed chip power by ``factor`` from window ``after_t`` on.

    The canonical drift injector for the §4.3 continuous-retraining loop:
    a chip whose power model shifted mid-segment (DVFS change, thermal
    throttle, firmware update) makes the counter model's predictions
    diverge from observation, which is exactly what ``retrain_needed``
    watches for.  System power is left untouched — only the chip reference
    (and hence the combined-mode chip/rest split) drifts.
    """

    def transform(ticks):
        for tk in ticks:
            if tk.t >= after_t and tk.w_chip is not None:
                tk = tk._replace(w_chip=tk.w_chip * factor)
            yield tk

    return transform


def _activity_numpy(trace: InvocationTrace, num_bins: int, dt: float) -> np.ndarray:
    """(T, M) event-based concurrency counts (simulator-side numpy twin of
    the reference's core.contribution.activity_series).

    Fully vectorized (scatter-add on the event grid): the fine grid has
    ``duration / dt`` bins, so the per-invocation Python loop this replaces
    dominated fleet-simulation time for hour-long traces."""
    events = np.zeros((num_bins + 1, trace.num_fns), np.float64)
    valid = trace.fn_id >= 0
    sbin = np.clip(np.floor(trace.start / dt).astype(np.int64), 0, num_bins)
    ebin = np.clip(np.floor(trace.end / dt).astype(np.int64), 0, num_bins)
    np.add.at(events, (sbin[valid], trace.fn_id[valid]), 1.0)
    np.add.at(events, (ebin[valid], trace.fn_id[valid]), -1.0)
    return np.cumsum(events[:num_bins], axis=0)


def _fleet_activity(
    traces: "list[InvocationTrace]", num_bins: int, dt: float
) -> np.ndarray:
    """(B, T, M) concurrency for a whole fleet in one scatter-add pass."""
    b = len(traces)
    m = traces[0].num_fns
    events = np.zeros((b, num_bins + 1, m), np.float64)
    bidx = np.concatenate(
        [np.full(t.fn_id.shape[0], i, np.int64) for i, t in enumerate(traces)]
    )
    fn_id = np.concatenate([t.fn_id for t in traces])
    start = np.concatenate([t.start for t in traces])
    end = np.concatenate([t.end for t in traces])
    valid = fn_id >= 0
    sbin = np.clip(np.floor(start / dt).astype(np.int64), 0, num_bins)
    ebin = np.clip(np.floor(end / dt).astype(np.int64), 0, num_bins)
    np.add.at(events, (bidx[valid], sbin[valid], fn_id[valid]), 1.0)
    np.add.at(events, (bidx[valid], ebin[valid], fn_id[valid]), -1.0)
    return np.cumsum(events[:, :num_bins], axis=1)


def _config_groups(configs) -> list:
    """Group node indices by identical sensor config, insertion-ordered.

    ``None`` entries (sensorless nodes — e.g. chipless edge platforms) are
    skipped.  The batched sensor chain is row-independent given per-node
    RNGs, so running it once per group and scattering rows back is bitwise
    what a homogeneous per-platform batch produces for the same nodes.
    """
    groups: dict = {}
    for i, c in enumerate(configs):
        if c is not None:
            groups.setdefault(c, []).append(i)
    return [(c, np.asarray(ix, np.int64)) for c, ix in groups.items()]


class NodeSimulator:
    """Ground-truth node simulator: invocation traces -> power telemetry.

    Synthesizes the paper's measurement substrate — per-function activity,
    a platform power model, and imperfect sensors (noise, lag, resampling)
    — so every profiling path can be validated against known per-function
    truth.  ``simulate`` covers one node, ``simulate_fleet`` a batch, and
    ``stream_fleet`` yields the same fleet telemetry tick-by-tick (bitwise
    identical under matched seeds) for the streaming/serving paths.

    Both fleet paths accept ``platforms=`` — one preset name per node — to
    simulate a *mixed* server/desktop/edge fleet in the same vectorized
    pass: per-node power-model parameters run stacked as ``(B,)`` arrays
    (``FleetPowerModel``), sensing groups nodes by identical sensor config,
    and chipless platforms simply get no chip signal (their telemetry rows
    fall back to pure mode downstream)."""

    def __init__(self, registry: FunctionRegistry, config: SimulatorConfig = SimulatorConfig()):
        self.registry = registry
        self.config = config
        plat = _PLATFORMS[config.platform]
        pcfg = config.power or PowerModelConfig(
            idle_w=plat["idle_w"], chip_idle_w=plat["chip_idle_w"]
        )
        self.power_cfg = pcfg
        self.model = NodePowerModel(
            pcfg,
            dyn_power_w=np.array([s.dyn_power_w for s in registry.specs]),
            cpu_frac=np.array([s.cpu_frac for s in registry.specs]),
        )
        self.system_sensor = config.system_sensor or plat["sensor"]
        self.chip_sensor = config.chip_sensor if plat["has_chip"] else None

    def simulate(self, trace: InvocationTrace, seed: int | None = None) -> SimResult:
        cfg = self.config
        num_bins = int(round(trace.duration / cfg.dt))
        act = _activity_numpy(trace, num_bins, cfg.dt)
        return self._finish(trace, act, seed=seed)

    def simulate_fleet(
        self,
        traces: list[InvocationTrace],
        seeds: list[int] | None = None,
        platforms: "list[str] | None" = None,
    ) -> list[SimResult]:
        """Simulate a fleet of nodes with one vectorized measurement pass.

        Activity scatter, the dynamic-power contractions, the physical
        truth, *and* the sensor front-ends run batched over all B nodes:
        one ``FleetPowerModel`` truth pass (per-node power-model parameters
        stacked as ``(B,)`` arrays), one ``sense_fleet`` call per sensor
        *config group* (one noise block draw per node, from its spawned
        child RNG) and one ``resample_fleet`` call per group — node ``i``'s
        telemetry is bitwise what a per-node ``simulate`` with the same seed
        produces.  Traces must share ``num_fns``; durations may differ (a
        *ragged* fleet — nodes joining/leaving at different times): the
        batched passes run padded to the longest node and each node's
        results cover exactly its own ``duration``, so every ``SimResult``
        has that node's own window count.

        ``platforms`` (one preset name per node) makes the fleet *mixed*:
        each node gets its platform's power config and system sensor, and
        chipless platforms (edge) produce no chip signal — their telemetry
        rows are bitwise what a homogeneous fleet of that platform yields
        under the same seeds."""
        if not traces:
            return []
        m0 = traces[0].num_fns
        if any(t.num_fns != m0 for t in traces):
            raise ValueError("simulate_fleet needs traces with equal num_fns")
        cfg = self.config
        b = len(traces)
        num_bins = int(round(max(t.duration for t in traces) / cfg.dt))
        act = _fleet_activity(traces, num_bins, cfg.dt)          # (B, T_max, M)
        p_dyn = np.einsum("btm,m->bt", act, self.model.dyn_power_w)
        p_cpu = np.einsum("btm,m->bt", act, self.model.dyn_power_w * self.model.cpu_frac)
        if seeds is None:
            # Distinct per-node default seeds: a shared cfg.seed would give
            # every node the identical sensor-noise realization, silently
            # correlating fleet-wide error statistics.
            seeds = [cfg.seed + i for i in range(b)]

        pcfgs, sys_cfgs, chip_cfgs = self._node_setups(platforms, b)
        fm = FleetPowerModel(pcfgs, self.model.dyn_power_w, self.model.cpu_frac)
        bins = np.array([int(round(t.duration / cfg.dt)) for t in traces])
        n_wins = [int(round(t.duration / cfg.delta)) for t in traces]
        cp_pow, true_sys, true_chip = self._fleet_truth(traces, p_dyn, p_cpu, num_bins, fm)
        cp_fracs, sys_fracs = self._fleet_fracs(fm, cp_pow, p_cpu, bins, n_wins)

        children = [np.random.default_rng(s).spawn(2) for s in seeds]
        sys_sigs, w_sys_rows = self._sense_groups(
            true_sys, sys_cfgs, [c[0] for c in children], bins, n_wins
        )
        chip_sigs, w_chip_rows = self._sense_groups(
            true_chip, chip_cfgs, [c[1] for c in children], bins, n_wins
        )

        out = []
        for i, t in enumerate(traces):
            out.append(
                self._finish(
                    t, act[i, : bins[i]], seed=seeds[i],
                    truth=(
                        cp_pow[i, : bins[i]], p_dyn[i, : bins[i]],
                        true_sys[i, : bins[i]], true_chip[i, : bins[i]],
                    ),
                    sensed=(sys_sigs[i], chip_sigs[i]),
                    windows=(w_sys_rows[i], w_chip_rows[i]),
                    model=fm.node(i),
                    fracs=(cp_fracs[i], sys_fracs[i]),
                )
            )
        return out

    def _node_setups(
        self, platforms: "list[str] | None", b: int
    ) -> tuple[list, list, list]:
        """Per-node ``(power config, system sensor, chip sensor | None)``.

        ``platforms=None`` is the homogeneous fleet: every node inherits
        this simulator's own platform.  Otherwise each node resolves its
        own preset, with the ``SimulatorConfig`` overrides (``power``,
        ``system_sensor``, ``chip_sensor``) still applying fleet-wide."""
        cfg = self.config
        if platforms is None:
            return [self.power_cfg] * b, [self.system_sensor] * b, [self.chip_sensor] * b
        if len(platforms) != b:
            raise ValueError(
                f"platforms must name one preset per trace; got {len(platforms)} for {b} traces"
            )
        pcfgs, sys_cfgs, chip_cfgs = [], [], []
        for name in platforms:
            if name not in _PLATFORMS:
                raise ValueError(f"unknown platform {name!r}; have {sorted(_PLATFORMS)}")
            plat = _PLATFORMS[name]
            pcfgs.append(
                cfg.power
                or PowerModelConfig(idle_w=plat["idle_w"], chip_idle_w=plat["chip_idle_w"])
            )
            sys_cfgs.append(cfg.system_sensor or plat["sensor"])
            chip_cfgs.append(cfg.chip_sensor if plat["has_chip"] else None)
        return pcfgs, sys_cfgs, chip_cfgs

    def _fleet_truth(
        self,
        traces: list[InvocationTrace],
        p_dyn: np.ndarray,
        p_cpu: np.ndarray,
        num_bins: int,
        fm: FleetPowerModel,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(B, T) physical truth for the whole fleet in one stacked pass —
        the fleet twin of ``_node_truth`` (each row bitwise equal on the
        node's own bins; padding bins carry idle physics that the causal,
        length-clamped sensor chain never reads)."""
        starts = [t.start[t.fn_id >= 0] for t in traces]
        cp = fm.control_plane_power(starts, num_bins, self.config.dt)
        return cp, fm.system_power(p_dyn, cp), fm.chip_power(p_cpu, cp)

    def _fleet_fracs(
        self,
        fm: FleetPowerModel,
        cp_pow: np.ndarray,
        p_cpu: np.ndarray,
        bins: np.ndarray,
        n_wins: list,
    ) -> tuple[list, list]:
        """Per-node window-mean CPU fractions from the stacked fleet series
        (the ``_frac_windows`` twin; per-node busy peaks stay per-row)."""
        bpw = int(round(self.config.delta / self.config.dt))
        cp_f = fm.cp_cpu_fraction(cp_pow)
        sys_f = fm.sys_cpu_fraction(p_cpu, cp_pow, bins)
        cp_out, sys_out = [], []
        for i, n in enumerate(n_wins):
            n_full = n * bpw
            cp_out.append(cp_f[i, :n_full].reshape(n, -1).mean(1))
            sys_out.append(sys_f[i, :n_full].reshape(n, -1).mean(1))
        return cp_out, sys_out

    def _sense_groups(
        self,
        true_pad: np.ndarray,
        sensor_cfgs: list,
        rngs: list,
        bins: np.ndarray,
        n_wins: list,
    ) -> tuple[list, list]:
        """Sense + window-resample the fleet, one batched pass per group of
        nodes sharing a sensor config.  Returns per-node ``(signal, window
        series)`` lists; nodes with ``None`` config (no sensor) get ``None``
        in both."""
        b = true_pad.shape[0]
        sigs: list = [None] * b
        wins: list = [None] * b
        for cfg_g, idx in _config_groups(sensor_cfgs):
            fs = src.sense_fleet(
                true_pad[idx], self.config.dt, cfg_g,
                rngs=[rngs[i] for i in idx], lengths=bins[idx],
            )
            n_g = max(n_wins[i] for i in idx)
            w_g = src.resample_fleet(fs, n_g, self.config.delta)
            for j, i in enumerate(idx):
                sigs[i] = fs.node(j)
                wins[i] = w_g[j, : n_wins[i]]
        return sigs, wins

    def _node_truth(
        self,
        trace: InvocationTrace,
        act: np.ndarray,
        p_dyn: np.ndarray | None = None,
        p_cpu: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fine-grid physical truth for one node.

        Returns ``(cp_power, p_dyn, true_sys, true_chip)`` — the single
        truth-generation chain shared by the batch (``_finish``) and
        streaming (``stream_fleet``) measurement paths, so the two cannot
        model different physics.
        """
        dt = self.config.dt
        t_grid = (np.arange(act.shape[0]) + 0.5) * dt
        valid_starts = trace.start[trace.fn_id >= 0]
        cp_power = self.model.control_plane_power(valid_starts, t_grid, dt)
        if p_dyn is None:
            p_dyn = act @ self.model.dyn_power_w
        true_sys = self.model.system_power(act, cp_power, p_dyn=p_dyn)
        true_chip = self.model.chip_power(act, cp_power, p_cpu=p_cpu)
        return cp_power, p_dyn, true_sys, true_chip

    def _frac_windows(
        self,
        act: np.ndarray,
        cp_power: np.ndarray,
        n_windows: int,
        model: NodePowerModel | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(N,) control-plane and system-wide CPU fractions as window means."""
        cfg = self.config
        model = self.model if model is None else model
        n_full = n_windows * int(round(cfg.delta / cfg.dt))
        cp_f = model.cp_cpu_fraction(cp_power)
        sys_f = model.sys_cpu_fraction(act, cp_power)
        return (
            cp_f[:n_full].reshape(n_windows, -1).mean(1),
            sys_f[:n_full].reshape(n_windows, -1).mean(1),
        )

    def _finish(
        self,
        trace: InvocationTrace,
        act: np.ndarray,
        *,
        seed: int | None,
        p_dyn: np.ndarray | None = None,
        p_cpu: np.ndarray | None = None,
        truth: tuple | None = None,
        sensed: tuple | None = None,
        windows: tuple | None = None,
        model: NodePowerModel | None = None,
        fracs: tuple | None = None,
    ) -> SimResult:
        cfg = self.config
        dt = cfg.dt
        model = self.model if model is None else model
        n_windows = int(round(trace.duration / cfg.delta))

        if truth is None:
            truth = self._node_truth(trace, act, p_dyn, p_cpu)
        cp_power, p_dyn, true_sys, true_chip = truth

        if sensed is None:
            # One spawned child RNG per sensor (system first, chip second) —
            # the same layout as the streaming path, so batch and streaming
            # telemetry are bitwise-identical under matched seeds.
            children = np.random.default_rng(cfg.seed if seed is None else seed).spawn(2)
            sys_sig = src.sense(true_sys, dt, self.system_sensor, children[0])
            chip_sig = (
                src.sense(true_chip, dt, self.chip_sensor, children[1])
                if self.chip_sensor
                else None
            )
        else:
            sys_sig, chip_sig = sensed

        if windows is None:
            w_sys = src.resample_to_windows(sys_sig, n_windows, cfg.delta)
            w_chip = (
                src.resample_to_windows(chip_sig, n_windows, cfg.delta)
                if chip_sig is not None
                else None
            )
        else:
            w_sys, w_chip = windows

        if fracs is None:
            cp_frac, sys_frac = self._frac_windows(act, cp_power, n_windows, model=model)
        else:
            cp_frac, sys_frac = fracs

        # Oracle per-function dynamic energy: linear share of the compressed
        # dynamic power (attribution of the compression is proportional).
        p_lin = p_dyn                                              # (T,)
        p_cmp = model._compress(p_lin)
        scale = np.where(p_lin > 0, p_cmp / np.maximum(p_lin, 1e-9), 1.0)
        fn_energy = (act * model.dyn_power_w[None, :] * scale[:, None]).sum(0) * dt
        busy_s = act.sum(0) * dt
        fn_power = np.where(busy_s > 0, fn_energy / np.maximum(busy_s, 1e-9), 0.0)

        # Host data plane: float32 CPU tensors; the profiler moves them to
        # its device.
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        telemetry = Telemetry(
            system_power=f32(w_sys),
            chip_power=f32(w_chip) if w_chip is not None else None,
            idle_watts=float(model.config.idle_w),
            cp_cpu_frac=f32(cp_frac),
            sys_cpu_frac=f32(sys_frac),
        )
        return SimResult(
            telemetry=telemetry,
            num_windows=n_windows,
            measured_energy_j=sys_sig.energy_j(),
            true_energy_j=float(np.sum(true_sys) * dt),
            true_fn_energy_j=fn_energy,
            true_fn_power_w=fn_power,
            true_cp_energy_j=float(np.sum(cp_power) * dt),
            system_signal=sys_sig,
            chip_signal=chip_sig,
            activity=act,
            fine_dt=dt,
        )

    def stream_fleet(
        self,
        traces: list[InvocationTrace],
        seeds: list[int] | None = None,
        platforms: "list[str] | None" = None,
    ) -> "Iterator[FleetTelemetryTick]":
        """Drive the sensor front-ends *live*: yield telemetry window by window.

        The physical truth (activity, true power) is still computed in one
        vectorized pass — it is the measurement path that streams, and it
        streams *batched*: the whole fleet shares one ``FleetStreamingSensor``
        per sensor kind, fed one window's worth of the (B, T) fine grid per
        iteration, its samples folded into one ``FleetWindowResampler``; a
        ``FleetTelemetryTick`` is yielded as soon as the fleet has closed
        window ``t`` on every signal (slow/laggy sensors close windows late,
        so yields can lag pushes and arrive in bursts — exactly like a real
        collection pipeline).

        RNG note: each sensor owns a child RNG spawned from the node seed
        (``np.random.default_rng(seed).spawn(2)``, system then chip) — the
        same layout as ``simulate_fleet``, so the two paths emit
        bitwise-identical telemetry on every valid tick entry.  Traces must
        share ``num_fns``; durations may differ (a ragged fleet): the shared
        sample clock keeps running past a node's end, its padding samples
        land strictly after its own last window edge, and once a node has
        ended the yielded ticks carry ``valid[i] = False`` with zeros in its
        value slots while the live nodes keep streaming.

        On a mixed fleet (``platforms=``), each sensor-config group streams
        through its own ``FleetStreamingSensor``/``FleetWindowResampler``
        pair and a window is yielded once *every* group has closed it;
        chipless nodes carry zeros in ``w_chip`` (their chip reference is
        identically absent — downstream treats them as pure-mode rows).

        Yields:
          ``FleetTelemetryTick`` with (B,) arrays per window, for every
          window index 0..max(N_i)-1 in order.
        """
        from repro_torch.telemetry.sources import FleetStreamingSensor, FleetWindowResampler

        if not traces:
            return
        m0 = traces[0].num_fns
        if any(t.num_fns != m0 for t in traces):
            raise ValueError("stream_fleet needs traces with equal num_fns")
        cfg = self.config
        b = len(traces)
        bins_per_win = int(round(cfg.delta / cfg.dt))
        n_list = [int(round(t.duration / cfg.delta)) for t in traces]
        n_arr = np.asarray(n_list)
        n_max = max(n_list)
        num_bins = int(round(max(t.duration for t in traces) / cfg.dt))
        act = _fleet_activity(traces, num_bins, cfg.dt)
        p_dyn = np.einsum("btm,m->bt", act, self.model.dyn_power_w)
        p_cpu = np.einsum("btm,m->bt", act, self.model.dyn_power_w * self.model.cpu_frac)
        if seeds is None:
            seeds = [cfg.seed + i for i in range(b)]

        pcfgs, sys_cfgs, chip_cfgs = self._node_setups(platforms, b)
        fm = FleetPowerModel(pcfgs, self.model.dyn_power_w, self.model.cpu_frac)
        bins = np.array([int(round(t.duration / cfg.dt)) for t in traces])
        cp_pow, true_sys, true_chip = self._fleet_truth(traces, p_dyn, p_cpu, num_bins, fm)
        cp_fracs, sys_fracs = self._fleet_fracs(fm, cp_pow, p_cpu, bins, n_list)

        children = [np.random.default_rng(s).spawn(2) for s in seeds]
        # One streaming sensor + resampler per sensor-config group; each
        # group keeps its own queue of closed (B_g,) window columns.
        def _streams(cfgs, truth, rng_col):
            return [
                (
                    idx,
                    truth,
                    FleetStreamingSensor(cfg_g, cfg.dt, [children[i][rng_col] for i in idx]),
                    FleetWindowResampler(cfg.delta, len(idx)),
                    [],
                )
                for cfg_g, idx in _config_groups(cfgs)
            ]

        sys_streams = _streams(sys_cfgs, true_sys, 0)
        chip_streams = _streams(chip_cfgs, true_chip, 1)
        has_chip = bool(chip_streams)
        emitted = 0

        def _drain() -> Iterator[FleetTelemetryTick]:
            nonlocal emitted
            while (
                emitted < n_max
                and all(q for *_, q in sys_streams)
                and all(q for *_, q in chip_streams)
            ):
                t = emitted
                live = t < n_arr
                w_sys = np.zeros(b)
                for idx, *_, q in sys_streams:
                    w_sys[idx] = q.pop(0)
                w_chip = None
                if has_chip:
                    w_chip = np.zeros(b)
                    for idx, *_, q in chip_streams:
                        w_chip[idx] = q.pop(0)
                    w_chip = np.where(live, w_chip, 0.0)
                yield FleetTelemetryTick(
                    t=t,
                    w_sys=np.where(live, w_sys, 0.0),
                    w_chip=w_chip,
                    cp_frac=np.asarray(
                        [cp_fracs[i][t] if live[i] else 0.0 for i in range(b)]
                    ),
                    sys_frac=np.asarray(
                        [sys_fracs[i][t] if live[i] else 0.0 for i in range(b)]
                    ),
                    valid=live,
                )
                emitted += 1

        for w in range(n_max):
            lo, hi = w * bins_per_win, (w + 1) * bins_per_win
            for idx, truth, sensor, rs, q in sys_streams + chip_streams:
                sig = sensor.push(truth[idx, lo:hi])
                q.extend(rs.push(sig.times, sig.watts).T)
            yield from _drain()
        # End of the fleet stream: close every window still open (lag and
        # slow sensors leave a tail that no future sample will close).
        for idx, truth, sensor, rs, q in sys_streams + chip_streams:
            q.extend(rs.flush(n_max).T)
        yield from _drain()

    def marginal_energy(
        self, trace: InvocationTrace, fn: int, seed: int | None = None
    ) -> float:
        """Paper Eq. 6 ground-truth protocol: run T(S) and T(S - f) through
        the *measured* (coarse) energy totals and divide by f's invocations."""
        from repro_torch.workload.trace import drop_function

        full = self.simulate(trace, seed=seed)
        without = self.simulate(drop_function(trace, fn), seed=seed)
        n_inv = trace.invocations_of(fn)
        return (full.measured_energy_j - without.measured_energy_j) / max(n_inv, 1)


class NodeSpan(NamedTuple):
    """One node's tenancy in a churn schedule: ``[join, leave)`` in ticks."""

    node: int
    join: int
    leave: int


def churn_schedule(
    num_nodes: int,
    horizon: int,
    *,
    capacity: int,
    seed: int = 0,
    mean_lifetime: float = 40.0,
    mean_gap: float = 4.0,
    min_lifetime: int = 4,
) -> list[NodeSpan]:
    """Generate a join/leave schedule for slot-pool serving benchmarks.

    Nodes arrive as a Poisson-ish process (exponential inter-arrival gaps of
    mean ``mean_gap`` ticks), live for an exponential lifetime of mean
    ``mean_lifetime`` ticks (floored at ``min_lifetime``), and leave.  The
    generator is a tiny host-side event simulation that never lets more than
    ``capacity`` nodes be live at once: an arrival that would exceed the
    pool waits for the earliest scheduled departure, which is exactly what a
    ``SlotAdmissionQueue`` in front of a full ``SlotFleetSession`` does.

    Spans are clipped to ``[0, horizon)``; nodes whose join would land at or
    past the horizon are dropped.  Returns spans sorted by join tick — ragged
    by construction, the stress case for length-bucketed packing.
    """
    if num_nodes <= 0:
        raise ValueError(f"num_nodes must be positive; got {num_nodes}")
    if capacity <= 0:
        raise ValueError(f"capacity must be positive; got {capacity}")
    if horizon <= 0:
        raise ValueError(f"horizon must be positive; got {horizon}")
    rng = np.random.default_rng(seed)
    # Min-heap of scheduled departure ticks for currently-live nodes.
    import heapq

    departures: list[int] = []
    spans: list[NodeSpan] = []
    t = 0.0
    for node in range(num_nodes):
        t += rng.exponential(mean_gap)
        join = int(t)
        while departures and departures[0] <= join:
            heapq.heappop(departures)
        if len(departures) >= capacity:
            # Pool full: this join queues until the earliest leave.
            join = max(join, heapq.heappop(departures))
        if join >= horizon:
            break
        life = max(int(rng.exponential(mean_lifetime)), min_lifetime)
        leave = min(join + life, horizon)
        heapq.heappush(departures, leave)
        spans.append(NodeSpan(node, join, leave))
        t = max(t, float(join))
    return spans
