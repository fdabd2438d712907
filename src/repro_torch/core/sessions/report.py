"""Shared report finalization: steps 5-6 of the pipeline, once for all paths.

Per-node and batched-segment profiling both end in a ``FootprintReport``
assembled by ``_finalize_report`` from the (estimates, trajectory,
contributions) tuple their engines produced, so the paths cannot drift.
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


def _per_fn_latency_stats(fn_id, start, end, num_fns):
    """(counts, mean, lat_sum, lat_sumsq) per function over a whole trace."""
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
    return counts, mean, lat_sum, lat_sumsq


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
