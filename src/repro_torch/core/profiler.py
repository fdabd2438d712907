"""FaasMeter profiler orchestrator (paper §4, Fig. 1).

Pipeline per accounting segment:

  1. synchronize the system power signal against the chip-power reference
     (Eq. 5 skew correction, §5);
  2. build contribution matrices C, A at window size delta, with the control
     plane appended as a shared principal (§4.1, Eq. 2);
  3. initial disaggregation over the N_init window -> X_0 (§4.2);
  4. Kalman steps over subsequent N_K batches -> X trajectory (§4.2);
  5. assemble the Shapley footprint spectrum (§4.4, Eq. 4).

Pure mode only: combined mode (§4.3, the CPU-counter model) is not ported
yet and raises (see ROADMAP.md).  ``start_fleet_stream`` opens the live
``StreamingFleetSession`` (``core.sessions``).  Entry points take
``device=`` (default ``"cuda"``); the simulator's float32 CPU telemetry and
the trace arrays are moved there on the way in.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import contribution as contrib
from repro_torch.core import sync as syncmod
from repro_torch.core.disaggregation import DisaggregationConfig, disaggregate
from repro_torch.core.engine.plan import segment_plan
from repro_torch.core.engine.segment import _NO_MESH
from repro_torch.core.kalman import KalmanConfig, kalman_init, run_kalman
from repro_torch.core.sessions.base import _NO_COMBINED
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
    "fleet_profile",
    "fleet_profile_batched",
    "segment_plan",
]

Tensor = torch.Tensor

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
    and the N_K Kalman step length, in delta-sized windows.
    """

    delta: float = 1.0             # disaggregation window (s), paper default
    init_windows: int = 100        # N_init ~ 100 s initial estimate (§6)
    step_windows: int = 60         # N_K = 60 s Kalman steps (§6)
    mode: str = "pure"             # pure | combined (§4.3, not ported)
    kalman: KalmanConfig = KalmanConfig()
    disagg: DisaggregationConfig = DisaggregationConfig()
    sync_max_shift: int = 16       # bound on skew search (windows)
    account_control_plane: bool = True


class FaasMeterProfiler:
    """Stateless-per-call profiler; hold one per node."""

    def __init__(self, config: ProfilerConfig = ProfilerConfig()):
        if config.mode == "combined":
            raise NotImplementedError(_NO_COMBINED)
        if config.mode != "pure":
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
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> FootprintReport:
        """Produce the footprint spectrum for one trace segment on ``device``.

        Args:
          fn_id/start/end: (K,) invocation trace arrays (fn_id < 0 = padding),
            numpy or tensors.
          num_fns: number of unique functions M.
          duration: segment length in seconds.
          telemetry: window-grid power signals (length N = duration/delta).
        """
        dev = resolve_device(device)
        fn_id, start, end = _trace_tensors(fn_id, start, end, dev)
        telemetry = telemetry.to(dev)
        cfg = self.config
        n_windows, init_n, s, n_used = segment_plan(cfg, duration)

        # --- 1+2. Sync + contribution assembly (shared with the fleet path).
        w_sys, skew, c_aug, cp_col = self._prep_node(
            fn_id, start, end, telemetry, num_fns, n_windows
        )
        m_aug = c_aug.shape[1]

        # --- 3+4. Initial disaggregation + Kalman trajectory.
        target = self._target_signal(w_sys, telemetry)
        x0 = disaggregate(c_aug[:init_n], target[:init_n], cfg.disagg)
        c_steps = None
        if s > 0:
            c_steps = c_aug[init_n:n_used].reshape(s, cfg.step_windows, m_aug)
            w_steps = target[init_n:n_used].reshape(s, cfg.step_windows)
            a_steps, lat_sums, lat_sumsqs = self._per_step_stats(
                fn_id, start, end, num_fns, m_aug, init_n, s
            )
            state, traj = run_kalman(
                kalman_init(m_aug, x0=x0), c_steps, w_steps, a_steps,
                lat_sums, lat_sumsqs, cfg.kalman,
            )
            x_final = state.x
        else:
            traj = x0[None, :]
            x_final = x0

        # --- 5. Shared finalization: spectrum + W_hat + Total-Error.
        counts, mean_lat, _, _ = _per_fn_latency_stats(fn_id, start, end, num_fns)
        x_cp = x_final[num_fns] if cp_col is not None else torch.zeros((), device=dev)
        return _finalize_report(
            x_fns=x_final[:num_fns], x_cp=x_cp, x0=x0, traj=traj,
            c_aug=c_aug, c_steps=c_steps,
            w_sys=w_sys, offset=telemetry.idle_watts,
            init_n=init_n, s=s, step_windows=cfg.step_windows,
            counts=counts, mean_lat=mean_lat, cp_col=cp_col,
            idle_watts=telemetry.idle_watts, duration=duration, skew=skew,
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
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> StreamingFleetSession:
        """Open an online profiling session for a fleet on ``device``.

        The streaming counterpart of ``fleet_profile_batched``: returns a
        ``StreamingFleetSession`` to be fed one telemetry window at a time
        via ``push_window`` (or a whole tick stream via ``ingest``);
        ``finalize`` yields the same per-node ``FootprintReport`` list.
        ``duration`` may be a per-node sequence (ragged fleet) and
        ``has_chip`` a per-node bool sequence (chipless rows zeroed on
        ingest).  Raises ``ValueError`` for configurations the streaming
        engine does not cover (non-default disaggregation, segments too
        short for a Kalman step, ragged nodes too short to bootstrap) and
        ``NotImplementedError`` for the unported mesh, slot-pool and
        combined-mode arguments (ROADMAP Queue 1 items 6 and 8).
        """
        return StreamingFleetSession(
            self, traces, num_fns=num_fns, duration=duration,
            idle_watts=idle_watts, has_chip=has_chip, has_cp=has_cp,
            on_tick=on_tick, on_bootstrap=on_bootstrap, mesh=mesh, slots=slots,
            fn_counters=fn_counters, counter_model=counter_model,
            window_features=window_features, device=device,
        )

    def _prep_node(self, fn_id, start, end, telemetry, num_fns, n_windows):
        """Steps 1-2 for one node: synchronize the system signal against the
        chip reference (Eq. 5), then assemble the contribution matrix with
        the control plane appended as a shared principal (§4.1, Eq. 2).
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
        )
        cp_col = None
        if cfg.account_control_plane and telemetry.cp_cpu_frac is not None:
            cp_col = contrib.shared_principal_contribution(
                telemetry.cp_cpu_frac[:n_windows],
                telemetry.sys_cpu_frac[:n_windows],
                delta=cfg.delta,
            )
            c = contrib.augment_with_principals(c, cp_col)
        return w_sys, skew, c, cp_col

    def _target_signal(self, w_sys: Tensor, telemetry: Telemetry) -> Tensor:
        """Pure-mode disaggregation target: idle-subtracted (X_No_Idle)."""
        return torch.clamp(w_sys - telemetry.idle_watts, min=0.0)

    def _per_step_stats(
        self, fn_id, start, end, num_fns, m_aug, init_n, s,
        *, step_windows: int | None = None,
    ):
        """Per-Kalman-step invocation counts + latency moments, by start time.

        Step indices come from float32 ``floor((start - t_begin) / step_len)``
        as in the reference, so invocations on a step edge land in the same
        step.  ``step_windows`` overrides the config's step size: the
        streaming session passes 1 for *per-window* statistics, whose sums
        over a step's windows are the per-step values.
        """
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
        return a_steps, lat_sums, lat_sumsqs


def fleet_profile(
    profiler: FaasMeterProfiler,
    traces: list[tuple],
    telemetries: list[Telemetry],
    *,
    num_fns: int,
    duration: float | Sequence[float],
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[FootprintReport]:
    """Profile many nodes one after another (the per-node reference path);
    ``duration`` may be a per-node sequence."""
    durations, _ = _node_durations(duration, len(traces))
    return [
        profiler.profile(f, st, en, num_fns=num_fns, duration=d, telemetry=tel, device=device)
        for (f, st, en), tel, d in zip(traces, telemetries, durations)
    ]


def fleet_profile_batched(
    profiler: FaasMeterProfiler,
    traces: list[tuple],
    telemetries: list[Telemetry],
    *,
    num_fns: int,
    duration: float | Sequence[float],
    mesh=None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[FootprintReport]:
    """Profile a whole fleet through the batched segment engine on ``device``.

    Per-node work is limited to sync and contribution-matrix assembly; the
    initial solve and the Kalman trajectory for all B nodes run as one
    fleet-wide ``run_fleet`` call, then each node's report is finalized
    against its own window count.

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
    b = len(traces)
    durations, ragged = _node_durations(duration, b)
    plans = [segment_plan(cfg, d) for d in durations]
    s_nodes = [p[2] for p in plans]
    s_max = max(s_nodes) if plans else 0
    if s_max == 0:
        # Too short for any Kalman trajectory: the per-node path handles
        # the init-only case already.
        return fleet_profile(
            profiler, traces, telemetries, num_fns=num_fns, duration=duration, device=dev
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
        fn_id, start, end = _trace_tensors(fn_id, start, end, dev)
        tel = tel.to(dev)
        w_sys, skew, c_aug, cp_col = profiler._prep_node(
            fn_id, start, end, tel, num_fns, n_windows_i
        )
        a_s, ls, lq = profiler._per_step_stats(
            fn_id, start, end, num_fns, c_aug.shape[1], init_n, s_i
        )
        counts, mean_lat, _, _ = _per_fn_latency_stats(fn_id, start, end, num_fns)
        nodes.append(dict(
            w_sys=w_sys, skew=skew, c_aug=c_aug, cp_col=cp_col,
            target=profiler._target_signal(w_sys, tel), a=a_s, ls=ls, lq=lq,
            counts=counts, mean_lat=mean_lat, idle=tel.idle_watts,
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

    has_cp = nodes[0]["cp_col"] is not None
    reports = []
    for i, nd in enumerate(nodes):
        s_i = s_nodes[i]
        reports.append(
            _finalize_report(
                x_fns=result.x_final[i, :num_fns],
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
                offset=nd["idle"],
                init_n=init_n, s=s_i, step_windows=n_w,
                counts=nd["counts"], mean_lat=nd["mean_lat"],
                cp_col=nd["cp_col"],
                idle_watts=nd["idle"],
                duration=durations[i], skew=nd["skew"],
            )
        )
    return reports
