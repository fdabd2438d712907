"""Shared report finalization: steps 5-6 of the pipeline, once for all paths.

Per-node, batched-segment and streaming profiling all end in a
``FootprintReport`` assembled by ``_finalize_report`` from the (estimates,
trajectory, contributions) tuple their engines produced, so the paths
cannot drift.  The small per-trace helpers the profiler and the sessions
share live here too, below both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.footprints import FootprintSpectrum, assemble_spectrum
from repro_torch.core.metrics import total_power_error

Tensor = torch.Tensor


class FootprintReport(NamedTuple):
    """One node's profiling outcome for an accounting segment (§4.4).

    ``total_error`` is the internal-validity metric (reconstruction vs the
    synchronized signal), not a ground-truth error.
    """

    spectrum: FootprintSpectrum      # per-function energy spectrum (M,)
    x_power: Tensor                  # (M,) final per-function power (watts)
    x_trajectory: Tensor             # (S, M) Kalman trajectory
    x_cp: Tensor                     # scalar: control-plane power estimate
    mean_latency: Tensor             # (M,)
    invocations: Tensor              # (M,)
    skew_windows: float              # estimated sensor skew (windows)
    total_error: float               # internal-validity Total-Error
    cp_energy: float                 # control-plane energy over segment (J)
    idle_energy: float               # idle energy over segment (J)


def _finalize_report(
    *,
    x_fns: Tensor,          # (M,) final per-function power
    x_cp: Tensor,           # scalar: control-plane power estimate
    x0: Tensor,             # (M_aug,) initial whole-trace estimate
    traj: Tensor,           # (S', M_aug) Kalman trajectory (x0[None] if S == 0)
    c_aug: Tensor,          # (N, M_aug) contribution matrix incl. principals
    c_steps: Tensor | None,  # (S, n_w, M_aug) step-grouped contributions
    w_sys: Tensor,          # (N,) synchronized raw system signal
    offset,                 # scalar or (N,): reconstruction offset (idle)
    init_n: int,
    s: int,
    step_windows: int,
    counts: Tensor,         # (M,) invocation counts over the segment
    mean_lat: Tensor,       # (M,) mean latency per function
    cp_col: Tensor | None,  # (N,) control-plane contribution column
    idle_watts: float,
    duration: float,
    skew: float,
    idle_extra_watts: float = 0.0,
) -> FootprintReport:
    """Profiler steps 5-6 (§4.4): control-plane and idle energy, the Shapley
    footprint spectrum, the time-varying W_hat reconstruction (X_0 over the
    init window, then each Kalman step's X), and the Total-Error against the
    synchronized signal."""
    dev = x_fns.device
    cp_energy = float(x_cp * torch.sum(cp_col)) if cp_col is not None else 0.0
    idle_energy = (idle_watts + float(idle_extra_watts)) * duration
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    spectrum = assemble_spectrum(
        x_fns, mean_lat, counts, scalar(cp_energy), scalar(idle_energy)
    )

    has_shape = isinstance(offset, torch.Tensor) and offset.ndim > 0
    w_hat_init = c_aug[:init_n] @ x0 + (offset[:init_n] if has_shape else offset)
    parts = [w_hat_init]
    if s > 0:
        per_step = torch.einsum("snm,sm->sn", c_steps, traj).reshape(-1)
        off_steps = offset[init_n : init_n + s * step_windows] if has_shape else offset
        parts.append(per_step + off_steps)
    w_hat = torch.cat([torch.atleast_1d(p) for p in parts])
    n_hat = w_hat.shape[0]
    terr = float(total_power_error(w_sys[:n_hat], w_hat))
    return FootprintReport(
        spectrum=spectrum,
        x_power=x_fns,
        x_trajectory=traj,
        x_cp=x_cp,
        mean_latency=mean_lat,
        invocations=counts,
        skew_windows=skew,
        total_error=terr,
        cp_energy=cp_energy,
        idle_energy=idle_energy,
    )


def _trace_tensors(fn_id, start, end, dev):
    """(fn_id, start, end) as int64/float32/float32 tensors on ``dev``."""
    return (
        torch.as_tensor(fn_id, dtype=torch.int64, device=dev),
        torch.as_tensor(start, dtype=torch.float32, device=dev),
        torch.as_tensor(end, dtype=torch.float32, device=dev),
    )


def _per_fn_latency_stats(fn_id, start, end, num_fns):
    """(counts, mean, lat_sum, lat_sumsq) per function over a whole trace.

    Summed on the host in a fixed order (CUDA's ``index_add_`` adds floats
    in a run-dependent one; see ``core.contribution``) and returned on the
    trace's device."""
    dev = start.device
    fn_id, start, end = fn_id.cpu(), start.cpu(), end.cpu()
    dur = torch.clamp(end - start, min=0.0)
    valid = fn_id >= 0
    seg = torch.where(valid, fn_id.to(torch.int64), num_fns)

    def seg_sum(vals):
        out = torch.zeros(num_fns + 1, dtype=torch.float32, device=dur.device)
        return out.index_add_(0, seg, vals)[:num_fns]

    counts = seg_sum(valid.to(torch.float32))
    lat_sum = seg_sum(torch.where(valid, dur, 0.0))
    lat_sumsq = seg_sum(torch.where(valid, dur * dur, 0.0))
    mean = lat_sum / torch.clamp(counts, min=1.0)
    return tuple(x.to(dev) for x in (counts, mean, lat_sum, lat_sumsq))


def _node_durations(duration, b: int) -> tuple[list[float], bool]:
    """Normalize a ``duration`` argument to per-node seconds: one float (the
    homogeneous fleet) or a length-B sequence (the ragged fleet).  Returns
    the per-node list plus whether the fleet is actually ragged."""
    if np.ndim(duration) == 0:
        return [float(duration)] * b, False
    durations = [float(d) for d in duration]
    if len(durations) != b:
        raise ValueError(
            f"duration sequence has {len(durations)} entries for {b} node(s)"
        )
    return durations, len(set(durations)) > 1


def finalize_streaming_session(sess) -> list[FootprintReport]:
    """Close a ``StreamingFleetSession`` segment and build per-node reports.

    Requires the full ``n_windows`` segment to have been pushed (the sync
    lookahead then unlocks every remaining tick).  On a ragged fleet each
    node finalizes against its own step count S_i and duration; a node with
    zero post-init steps reports its X_0 trajectory, as the per-node path
    would.  In combined mode each node's footprints add its ``x_cpu`` and
    its reconstruction offset is its raw chip series plus its rest-side
    idle, as on the batch paths.  (The reference's slot-pool branch waits
    for ROADMAP Queue 1 item 8.)
    """
    if sess._n_raw < sess.n_windows:
        raise ValueError(
            f"finalize needs the full segment: got {sess._n_raw} of "
            f"{sess.n_windows} windows"
        )
    sess._advance()
    assert sess._next_tick == sess.n_used and len(sess._traj) == sess.s
    cfg = sess.cfg
    dev = sess.device
    traj = torch.stack(sess._traj, dim=1)                       # (B, S, M_aug)
    x_final = sess.state.kalman.x.clone()
    w_sys = torch.as_tensor(np.stack(sess._w_sync, axis=1), device=dev)  # (B, n_used)
    c_aug = sess._c_aug_block(0, sess.n_windows)
    cp_col = (
        torch.as_tensor(np.stack(sess._cp_col, axis=1), device=dev) if sess.has_cp else None
    )
    if sess.combined:
        chip = torch.as_tensor(np.stack(sess._raw_chip, axis=1), device=dev)  # (B, n_raw)
        resid = sess._x_cpu_resid.cpu()
    reports = []
    for i in range(sess.b):
        s_i = sess.s_nodes[i]
        n_used_i = sess.init_n + s_i * cfg.step_windows
        idle_i = float(sess.idle_watts[i])
        x_fns_i = x_final[i, : sess.num_fns]
        offset_i, idle_extra_i = idle_i, 0.0
        if sess.combined:
            x_fns_i = x_fns_i + sess.x_cpu[i]
            offset_i = chip[i, : int(sess._n_nodes[i])] + float(sess._rest_idle_nodes[i])
            idle_extra_i = float(resid[i])
        reports.append(
            _finalize_report(
                x_fns=x_fns_i,
                x_cp=x_final[i, sess.num_fns] if sess.has_cp else torch.zeros((), device=dev),
                x0=sess.x0[i],
                traj=traj[i, :s_i] if s_i > 0 else sess.x0[i][None],
                c_aug=c_aug[i],
                c_steps=(
                    c_aug[i, sess.init_n : n_used_i].reshape(s_i, cfg.step_windows, sess.m_aug)
                    if s_i > 0
                    else None
                ),
                w_sys=w_sys[i],
                offset=offset_i,
                init_n=sess.init_n, s=s_i, step_windows=cfg.step_windows,
                counts=sess.counts[i], mean_lat=sess.mean_latency[i],
                cp_col=cp_col[i] if sess.has_cp else None,
                idle_watts=idle_i,
                duration=sess.durations[i],
                skew=float(sess.skews[i]),
                idle_extra_watts=idle_extra_i,
            )
        )
    return reports
