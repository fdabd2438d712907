"""FaasMeter profiler orchestrator (paper §4, Fig. 1).

Pipeline per accounting segment:

  1. synchronize the system power signal against the chip-power reference
     (Eq. 5 skew correction, §5);
  2. build contribution matrices C, A at window size delta, with the control
     plane appended as a shared principal (§4.1, Eq. 2);
  3. initial disaggregation over the N_init window -> X_0 (§4.2);
  4. Kalman steps over subsequent N_K batches -> X trajectory (§4.2);
  5. (combined mode) add the CPU-model estimate to the 'rest' disaggregation
     X = X_CPU + X_Rest (§4.3);
  6. assemble the Shapley footprint spectrum (§4.4, Eq. 4).

``start_fleet_stream`` opens the live ``StreamingFleetSession``
(``core.sessions``).  Entry points take ``device=`` (default ``"cuda"``);
the simulator's float32 CPU telemetry is moved there on the way in.  The
trace's statistics (contribution matrix, per-step invocation counts and
latency moments) are summed on the host in a fixed order and copied to the
device once, so a run on the card gives the same bits every time and
starts from the CPU's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import contribution as contrib
from repro_torch.core import cpu_model as cpumod
from repro_torch.core import sync as syncmod
from repro_torch.core.disaggregation import DisaggregationConfig, disaggregate
from repro_torch.core.engine.plan import segment_plan
from repro_torch.core.engine.segment import _NO_MESH
from repro_torch.core.engine.targets import combined_rest_target, fleet_rest_idle
from repro_torch.core.kalman import KalmanConfig, kalman_init, run_kalman
from repro_torch.core.sessions.combined import (
    _as_fleet_counters,
    _as_fleet_model,
    combined_chip_power,
    prepare_combined_fleet,
)
from repro_torch.core.sessions.drain import StreamTick
from repro_torch.core.sessions.report import (
    FootprintReport,
    _finalize_report,
    _node_durations,
    _per_fn_latency_stats,
    _trace_tensors,
)
from repro_torch.core.sessions.streaming import StreamingFleetSession
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "FaasMeterProfiler",
    "FootprintReport",
    "ProfilerConfig",
    "StreamTick",
    "StreamingFleetSession",
    "Telemetry",
    "combined_chip_power",
    "fleet_profile",
    "fleet_profile_batched",
    "prepare_combined_fleet",
    "segment_plan",
]

Tensor = torch.Tensor
_HOST = torch.device("cpu")


class Telemetry(NamedTuple):
    """Signals resampled onto the delta window grid (length N each)."""

    system_power: Tensor          # (N,) watts, full-system (IPMI/plug-like)
    chip_power: Tensor | None     # (N,) watts, chip/CPU (RAPL-like); sync ref
    idle_watts: float             # static idle power of the node
    cp_cpu_frac: Tensor | None    # (N,) control-plane CPU fraction
    sys_cpu_frac: Tensor | None   # (N,) system-wide CPU fraction

    def to(self, device: torch.device) -> "Telemetry":
        """The same telemetry with every series on ``device``."""
        move = lambda t: None if t is None else torch.as_tensor(t, dtype=torch.float32, device=device)
        return Telemetry(
            system_power=move(self.system_power),
            chip_power=move(self.chip_power),
            idle_watts=self.idle_watts,
            cp_cpu_frac=move(self.cp_cpu_frac),
            sys_cpu_frac=move(self.sys_cpu_frac),
        )


@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """Profiler hyperparameters (paper §6 defaults).

    ``init_windows``/``step_windows`` fix the N_init initial-estimate block
    and the N_K Kalman step length, in delta-sized windows; ``mode``
    selects pure disaggregation or the combined CPU-counter model (§4.3).
    """

    delta: float = 1.0             # disaggregation window (s), paper default
    init_windows: int = 100        # N_init ~ 100 s initial estimate (§6)
    step_windows: int = 60         # N_K = 60 s Kalman steps (§6)
    mode: str = "pure"             # pure | combined (§4.3)
    kalman: KalmanConfig = KalmanConfig()
    disagg: DisaggregationConfig = DisaggregationConfig()
    sync_max_shift: int = 16       # bound on skew search (windows)
    account_control_plane: bool = True


class FaasMeterProfiler:
    """Stateless-per-call profiler; hold one per node."""

    def __init__(self, config: ProfilerConfig = ProfilerConfig()):
        if config.mode not in ("pure", "combined"):
            raise ValueError(f"unknown profiler mode {config.mode!r}")
        self.config = config

    def profile(
        self,
        fn_id,
        start,
        end,
        *,
        num_fns: int,
        duration: float,
        telemetry: Telemetry,
        fn_counters=None,
        counter_model: cpumod.LinearPowerModel | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> FootprintReport:
        """Produce the footprint spectrum for one trace segment on ``device``.

        Args:
          fn_id/start/end: (K,) invocation trace arrays (fn_id < 0 = padding),
            numpy or tensors.
          num_fns: number of unique functions M.
          duration: segment length in seconds.
          telemetry: window-grid power signals (length N = duration/delta).
          fn_counters: (M, F) normalized per-function step counters
            (combined mode only).
          counter_model: trained ``LinearPowerModel`` (combined mode only).
        """
        dev = resolve_device(device)
        fn_id, start, end = _trace_tensors(fn_id, start, end, _HOST)
        telemetry = telemetry.to(dev)
        cfg = self.config
        n_windows, init_n, s, n_used = segment_plan(cfg, duration)

        # --- 1+2. Sync + contribution assembly (shared with the fleet path).
        w_sys, skew, c_aug, cp_col = self._prep_node(
            fn_id, start, end, telemetry, num_fns, n_windows
        )
        m_aug = c_aug.shape[1]

        # --- 3+4. Initial disaggregation + Kalman trajectory.
        target = self._target_signal(w_sys, telemetry, init_n)
        x0 = disaggregate(c_aug[:init_n], target[:init_n], cfg.disagg)
        c_steps = None
        if s > 0:
            c_steps = c_aug[init_n:n_used].reshape(s, cfg.step_windows, m_aug)
            w_steps = target[init_n:n_used].reshape(s, cfg.step_windows)
            a_steps, lat_sums, lat_sumsqs = (
                x.to(dev) for x in self._per_step_stats(fn_id, start, end, num_fns, m_aug, init_n, s)
            )
            state, traj = run_kalman(
                kalman_init(m_aug, x0=x0), c_steps, w_steps, a_steps,
                lat_sums, lat_sumsqs, cfg.kalman,
            )
            x_final = state.x
        else:
            traj = x0[None, :]
            x_final = x0

        # --- 5. Combined mode: X = X_CPU + X_Rest (§4.3), shared helper.  A
        # chipless node degenerates to pure mode: no chip reference means no
        # counter split and a pure target (``_target_signal`` fell back).
        combined = cfg.mode == "combined" and telemetry.chip_power is not None
        x_fns = x_final[:num_fns]
        offset = telemetry.idle_watts
        idle_extra = 0.0
        if combined:
            if fn_counters is None or counter_model is None:
                raise ValueError("combined mode needs fn_counters, counter_model")
            f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)
            model = cpumod.LinearPowerModel(f32(counter_model.weights), f32(counter_model.bias))
            x_cpu, x_cpu_resid = combined_chip_power(
                model, f32(fn_counters), c_aug[:, :num_fns].sum(dim=0), duration
            )
            x_fns = x_fns + x_cpu
            idle_extra = float(x_cpu_resid)
            offset = telemetry.chip_power[:n_windows] + self._rest_idle(telemetry, init_n)

        # --- 6. Shared finalization: spectrum + W_hat + Total-Error.
        counts, mean_lat, _, _ = (
            x.to(dev) for x in _per_fn_latency_stats(fn_id, start, end, num_fns)
        )
        x_cp = x_final[num_fns] if cp_col is not None else torch.zeros((), device=dev)
        return _finalize_report(
            x_fns=x_fns, x_cp=x_cp, x0=x0, traj=traj,
            c_aug=c_aug, c_steps=c_steps,
            w_sys=w_sys, offset=offset,
            init_n=init_n, s=s, step_windows=cfg.step_windows,
            counts=counts, mean_lat=mean_lat, cp_col=cp_col,
            idle_watts=telemetry.idle_watts, duration=duration, skew=skew,
            idle_extra_watts=idle_extra,
        )

    def start_fleet_stream(
        self,
        traces: list[tuple],
        *,
        num_fns: int,
        duration: float | Sequence[float],
        idle_watts,
        has_chip,
        has_cp: bool,
        on_tick=None,
        on_bootstrap=None,
        mesh=None,
        slots: int | None = None,
        fn_counters=None,
        counter_model=None,
        window_features=None,
        retrain_config: cpumod.CpuModelConfig = cpumod.CpuModelConfig(),
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> StreamingFleetSession:
        """Open an online profiling session for a fleet on ``device``.

        The streaming counterpart of ``fleet_profile_batched``: returns a
        ``StreamingFleetSession`` to be fed one telemetry window at a time
        via ``push_window`` (or a whole tick stream via ``ingest``);
        ``finalize`` yields the same per-node ``FootprintReport`` list.
        ``duration`` may be a per-node sequence (ragged fleet) and
        ``has_chip`` a per-node bool sequence (chipless rows zeroed on
        ingest, so their combined targets are the pure ones).  Combined
        mode (§4.3) needs a chip reference on at least one node plus
        per-node ``fn_counters`` and ``counter_model`` (see
        ``prepare_combined_fleet``); pass ``window_features`` as well for
        retrain checks at every Kalman-step boundary, against
        ``retrain_config``'s threshold.  Raises ``ValueError`` for
        configurations the streaming engine does not cover (non-default
        disaggregation, segments too short for a Kalman step, ragged nodes
        too short to bootstrap) and ``NotImplementedError`` for the
        unported mesh and slot-pool arguments (ROADMAP Queue 1 item 8).
        """
        return StreamingFleetSession(
            self, traces, num_fns=num_fns, duration=duration,
            idle_watts=idle_watts, has_chip=has_chip, has_cp=has_cp,
            on_tick=on_tick, on_bootstrap=on_bootstrap, mesh=mesh, slots=slots,
            fn_counters=fn_counters, counter_model=counter_model,
            window_features=window_features, retrain_config=retrain_config,
            device=device,
        )

    def _prep_node(self, fn_id, start, end, telemetry, num_fns, n_windows):
        """Steps 1-2 for one node: synchronize the system signal against the
        chip reference (Eq. 5), then assemble the contribution matrix (on
        the host, from the host trace) with the control plane appended as a
        shared principal (§4.1, Eq. 2), on the telemetry's device.
        Returns ``(w_sys, skew, c_aug, cp_col)``."""
        cfg = self.config
        w_sys = telemetry.system_power[:n_windows]
        skew = 0.0
        if telemetry.chip_power is not None:
            w_sys, skew_t = syncmod.synchronize(
                w_sys, telemetry.chip_power[:n_windows], max_shift=cfg.sync_max_shift
            )
            skew = float(skew_t)
        c = contrib.contribution_matrix(
            fn_id, start, end, num_fns=num_fns, num_windows=n_windows, delta=cfg.delta
        ).to(w_sys.device)
        cp_col = None
        if cfg.account_control_plane and telemetry.cp_cpu_frac is not None:
            cp_col = contrib.shared_principal_contribution(
                telemetry.cp_cpu_frac[:n_windows],
                telemetry.sys_cpu_frac[:n_windows],
                delta=cfg.delta,
            )
            c = contrib.augment_with_principals(c, cp_col)
        return w_sys, skew, c, cp_col

    def _target_signal(self, w_sys: Tensor, telemetry: Telemetry, init_n: int) -> Tensor:
        """Disaggregation target per mode (always idle-subtracted: X_No_Idle).

        Combined mode with a chip reference disaggregates the 'rest' power
        (``engine.combined_rest_target``, the helper every path shares); a
        chipless node falls back to the pure target — equivalently, its
        chip series is identically zero, under which the combined target
        with ``rest_idle = idle`` IS the pure one.
        """
        if self.config.mode == "combined" and telemetry.chip_power is not None:
            return combined_rest_target(
                w_sys, telemetry.chip_power[: w_sys.shape[0]], self._rest_idle(telemetry, init_n)
            )
        return torch.clamp(w_sys - telemetry.idle_watts, min=0.0)

    def _rest_idle(self, telemetry: Telemetry, init_n: int) -> Tensor:
        """Idle power of the non-chip components: total idle minus the
        chip's floor over the N_init block (never the telemetry's full
        length — a chip series longer than the segment must not change the
        estimate), kept on the device (no host read)."""
        return fleet_rest_idle(telemetry.chip_power[:init_n], telemetry.idle_watts)

    def _per_step_stats(
        self, fn_id, start, end, num_fns, m_aug, init_n, s,
        *, step_windows: int | None = None,
    ):
        """Per-Kalman-step invocation counts + latency moments, by start time.

        Step indices come from float32 ``floor((start - t_begin) / step_len)``
        as in the reference, so invocations on a step edge land in the same
        step.  ``step_windows`` overrides the config's step size: the
        streaming session passes 1 for *per-window* statistics, whose sums
        over a step's windows are the per-step values.  Summed on the host
        in a fixed order (see ``core.contribution``) and returned on the
        trace's device.
        """
        dev = start.device
        fn_id, start, end = fn_id.cpu(), start.cpu(), end.cpu()
        cfg = self.config
        sw = cfg.step_windows if step_windows is None else step_windows
        t_begin = init_n * cfg.delta
        step_len = sw * cfg.delta
        step_idx = torch.floor((start - t_begin) / step_len).to(torch.int64)
        valid = (fn_id >= 0) & (step_idx >= 0) & (step_idx < s)
        seg = torch.where(valid, step_idx * num_fns + torch.clamp(fn_id, 0, num_fns - 1), s * num_fns)
        dur = torch.clamp(end - start, min=0.0)

        def scat(vals):
            out = torch.zeros(s * num_fns + 1, dtype=torch.float32, device=dur.device)
            return out.index_add_(0, seg, torch.where(valid, vals, 0.0))[:-1].reshape(s, num_fns)

        a_steps = scat(torch.ones_like(dur))
        lat_sums = scat(dur)
        lat_sumsqs = scat(dur * dur)
        if m_aug > num_fns:
            # Shared principals: always-active row; one pseudo-invocation per
            # step keeps its Kalman gain alive, zero latency variance.
            pad = torch.ones((s, m_aug - num_fns), dtype=torch.float32, device=dur.device)
            a_steps = torch.cat([a_steps, pad], dim=1)
            lat_sums = torch.cat([lat_sums, pad * 0.0], dim=1)
            lat_sumsqs = torch.cat([lat_sumsqs, pad * 0.0], dim=1)
        return a_steps.to(dev), lat_sums.to(dev), lat_sumsqs.to(dev)


def fleet_profile(
    profiler: FaasMeterProfiler,
    traces: list[tuple],
    telemetries: list[Telemetry],
    *,
    num_fns: int,
    duration: float | Sequence[float],
    fn_counters=None,
    counter_model=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[FootprintReport]:
    """Profile many nodes one after another (the per-node reference path);
    ``duration`` may be a per-node sequence.  In combined mode pass
    per-node ``fn_counters`` ((B, M, F) or a list) and ``counter_model``
    (fleet-batched, a list, or one shared model; see
    ``prepare_combined_fleet``)."""
    dev = resolve_device(device)
    b = len(traces)
    durations, _ = _node_durations(duration, b)
    per_node = [{} for _ in range(b)]
    if profiler.config.mode == "combined":
        if fn_counters is None or counter_model is None:
            raise ValueError(
                "combined mode needs fn_counters and counter_model "
                "(see prepare_combined_fleet)"
            )
        fnc = _as_fleet_counters(fn_counters, b, num_fns, dev)
        models = _as_fleet_model(counter_model, b, dev)
        per_node = [
            dict(fn_counters=fnc[i], counter_model=cpumod.model_row(models, i)) for i in range(b)
        ]
    return [
        profiler.profile(f, st, en, num_fns=num_fns, duration=d, telemetry=tel, device=dev, **kw)
        for (f, st, en), tel, d, kw in zip(traces, telemetries, durations, per_node)
    ]


def fleet_profile_batched(
    profiler: FaasMeterProfiler,
    traces: list[tuple],
    telemetries: list[Telemetry],
    *,
    num_fns: int,
    duration: float | Sequence[float],
    mesh=None,
    fn_counters=None,
    counter_model=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[FootprintReport]:
    """Profile a whole fleet through the batched segment engine on ``device``.

    Per-node work is limited to sync and contribution-matrix assembly; the
    initial solve and the Kalman trajectory for all B nodes run as one
    fleet-wide ``run_fleet`` call, then each node's report is finalized
    against its own window count.

    In combined mode (§4.3) the engine disaggregates each node's
    chip-subtracted 'rest' target (``engine.combined_rest_target``) and
    finalization adds the counter model's per-function X_CPU — pass
    ``fn_counters`` ((B, M, F) or a per-node list) and ``counter_model``
    (fleet-batched, a list, or one shared model; see
    ``prepare_combined_fleet``), with chip power on at least one node.
    Chipless nodes (the edge platform in a mixed fleet) fall back to pure
    mode inside the same batch: pure target, zero chip split, pure offset —
    one engine call, the platform mix is data.

    Ragged fleets: ``duration`` may be a per-node sequence.  Every node must
    cover the common N_init window; past it, nodes contribute their own
    ``S_i`` full Kalman steps, the batch pads to ``max(S_i)`` with a
    validity mask, and nodes with zero post-init steps report X_0.
    """
    from repro_torch.core import engine as eng

    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    dev = resolve_device(device)
    cfg = profiler.config
    if not cfg.disagg.nonneg or cfg.disagg.mode != "no_idle":
        raise ValueError(
            "fleet_profile_batched supports the default NNLS/no_idle "
            "disaggregation config only"
        )
    combined = cfg.mode == "combined"
    b = len(traces)
    if combined:
        if fn_counters is None or counter_model is None:
            raise ValueError(
                "combined mode needs fn_counters and counter_model "
                "(see prepare_combined_fleet)"
            )
        if all(tel.chip_power is None for tel in telemetries):
            raise ValueError("combined mode needs chip_power on at least one node")
    durations, ragged = _node_durations(duration, b)
    plans = [segment_plan(cfg, d) for d in durations]
    s_nodes = [p[2] for p in plans]
    s_max = max(s_nodes) if plans else 0
    if s_max == 0:
        # Too short for any Kalman trajectory: the per-node path handles
        # the init-only case already.
        return fleet_profile(
            profiler, traces, telemetries, num_fns=num_fns, duration=duration,
            fn_counters=fn_counters, counter_model=counter_model, device=dev,
        )
    init_n = plans[0][1]
    if any(p[1] != init_n for p in plans):
        raise ValueError(
            "fleet_profile_batched needs every node to cover the common "
            f"N_init window ({cfg.init_windows} windows); got per-node "
            f"init blocks {[p[1] for p in plans]} (use fleet_profile)"
        )
    has_cp_flags = [
        cfg.account_control_plane and tel.cp_cpu_frac is not None for tel in telemetries
    ]
    if len(set(has_cp_flags)) > 1:
        raise ValueError(
            "fleet_profile_batched needs a homogeneous fleet: telemetries "
            "mix present/absent cp_cpu_frac (use fleet_profile instead)"
        )

    n_w = cfg.step_windows
    post_max = s_max * n_w
    nodes = []
    for (fn_id, start, end), tel, (n_windows_i, _, s_i, _) in zip(traces, telemetries, plans):
        # The trace stays on the host: its statistics are summed there.
        fn_id, start, end = _trace_tensors(fn_id, start, end, _HOST)
        tel = tel.to(dev)
        w_sys, skew, c_aug, cp_col = profiler._prep_node(
            fn_id, start, end, tel, num_fns, n_windows_i
        )
        a_s, ls, lq = profiler._per_step_stats(
            fn_id, start, end, num_fns, c_aug.shape[1], init_n, s_i
        )
        counts, mean_lat, _, _ = _per_fn_latency_stats(fn_id, start, end, num_fns)
        chip = combined and tel.chip_power is not None
        nodes.append(dict(
            w_sys=w_sys, skew=skew, c_aug=c_aug, cp_col=cp_col,
            # A chipless node's target falls back to pure mode, so a mixed
            # combined fleet stays one engine call.
            target=profiler._target_signal(w_sys, tel, init_n),
            a=a_s.to(dev), ls=ls.to(dev), lq=lq.to(dev),
            counts=counts.to(dev), mean_lat=mean_lat.to(dev), idle=tel.idle_watts,
            offset=(
                tel.chip_power[:n_windows_i] + profiler._rest_idle(tel, init_n)
                if chip
                else tel.idle_watts
            ),
            chip=chip,
        ))
    m_aug = nodes[0]["c_aug"].shape[1]

    def pad_rows(x, rows):
        """Zero-pad axis 0 of ``x`` to ``rows``."""
        if x.shape[0] == rows:
            return x
        return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])

    post = lambda key, s_i, nd: pad_rows(nd[key][init_n : init_n + s_i * n_w], post_max)
    mask = None
    if ragged:
        tick_ok = np.arange(post_max)[None, :] < (np.asarray(s_nodes) * n_w)[:, None]
        if not tick_ok.all():
            mask = torch.as_tensor(tick_ok.reshape(b, s_max, n_w), dtype=torch.float32, device=dev)
    inputs = eng.FleetInputs(
        c=torch.stack([post("c_aug", s_i, nd) for nd, s_i in zip(nodes, s_nodes)]).reshape(
            b, s_max, n_w, m_aug
        ),
        w=torch.stack([post("target", s_i, nd) for nd, s_i in zip(nodes, s_nodes)]).reshape(
            b, s_max, n_w
        ),
        a=torch.stack([pad_rows(nd["a"], s_max) for nd in nodes]),
        lat_sum=torch.stack([pad_rows(nd["ls"], s_max) for nd in nodes]),
        lat_sumsq=torch.stack([pad_rows(nd["lq"], s_max) for nd in nodes]),
        mask=mask,
    )
    engine_cfg = eng.EngineConfig(
        kalman=cfg.kalman, delta=cfg.delta,
        init_iters=cfg.disagg.nnls_iters,
        init_ridge_lambda=cfg.disagg.ridge_lambda,
    )
    result = eng.run_fleet(
        inputs, engine_cfg,
        init_c=torch.stack([nd["c_aug"][:init_n] for nd in nodes]),
        init_w=torch.stack([nd["target"][:init_n] for nd in nodes]),
        # Per-tick attribution is a (B, T, M) dense product nothing in the
        # report consumes; callers that want it use the engine directly.
        with_ticks=False,
        device=dev,
    )

    # Combined mode: one fleet-batched chip-side split (§4.3) — per-node
    # busy seconds against per-node counter models, no loop over nodes.
    x_cpu = x_cpu_resid = None
    if combined:
        models = _as_fleet_model(counter_model, b, dev)
        fnc = _as_fleet_counters(fn_counters, b, num_fns, dev)
        busy = torch.stack([nd["c_aug"][:, :num_fns].sum(dim=0) for nd in nodes])  # (B, M) s
        x_cpu, x_cpu_resid = combined_chip_power(
            models, fnc, busy, torch.as_tensor(durations, dtype=torch.float32)
        )
        x_cpu_resid = x_cpu_resid.cpu()

    has_cp = nodes[0]["cp_col"] is not None
    reports = []
    for i, nd in enumerate(nodes):
        s_i = s_nodes[i]
        x_fns = result.x_final[i, :num_fns]
        idle_extra = 0.0
        if nd["chip"]:
            x_fns = x_fns + x_cpu[i]
            idle_extra = float(x_cpu_resid[i])
        reports.append(
            _finalize_report(
                x_fns=x_fns,
                x_cp=result.x_final[i, num_fns] if has_cp else torch.zeros((), device=dev),
                x0=result.x0[i],
                traj=result.x_trajectory[i, :s_i] if s_i > 0 else result.x0[i][None],
                c_aug=nd["c_aug"],
                c_steps=(
                    nd["c_aug"][init_n : init_n + s_i * n_w].reshape(s_i, n_w, m_aug)
                    if s_i > 0
                    else None
                ),
                w_sys=nd["w_sys"],
                offset=nd["offset"],
                init_n=init_n, s=s_i, step_windows=n_w,
                counts=nd["counts"], mean_lat=nd["mean_lat"],
                cp_col=nd["cp_col"],
                idle_watts=nd["idle"],
                duration=durations[i], skew=nd["skew"],
                idle_extra_watts=idle_extra,
            )
        )
    return reports
