"""Baseline energy profilers the paper compares against (§3, §6.1).

- ``direct_attribution`` / ``scaphandre_like`` — Scaphandre-like: read the
  (chip) power sensor and split each sample over the components running in
  that sampling interval.  CPU power only, no shared-resource accounting;
  accuracy collapses as concurrency grows and when the sensor is stale (the
  paper measured 10x-23x error on the server).
- ``model_only_attribution`` — PowerAPI/SmartWatts-like: per-function power
  purely from a utilization->power model, never consulting the measured
  system power (paper Fig. 2b).

All three consume the same array-level inputs as FaasMeter, so a benchmark
can swap profilers symmetrically.  Plain torch on tensors, run on
``device`` (default the card); no kernel is on this path.
"""

from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def direct_attribution(
    activity,        # (T, M) concurrent invocations per fine bin (dt)
    chip_power,      # (T,) high-frequency chip power samples (watts)
    dt: float,
    mean_latency,    # (M,) unused, kept for the reference's signature
    invocations,     # (M,) total invocation counts
    *,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Idealized direct attribution (perfect-sampling upper bound): each
    fine sample's power is divided over the active components in
    proportion to their activity; per-function energy accumulates and is
    divided by the invocation count.  ``scaphandre_like`` is the faithful
    model with staleness and resident-container splitting."""
    dev = resolve_device(device)
    act = _f32(activity, dev)
    chip = _f32(chip_power, dev)
    total_active = act.sum(dim=1, keepdim=True)
    share = torch.where(
        total_active > 0, act / torch.clamp(total_active, min=1.0), torch.zeros_like(act)
    )
    energy_per_fn = (share * chip[:, None]).sum(dim=0) * dt
    return energy_per_fn / torch.clamp(_f32(invocations, dev), min=1.0)


def scaphandre_like(
    activity,        # (T, M) concurrent invocations per fine bin (dt)
    chip_power,      # (T,) chip (RAPL) power on the fine grid
    dt: float,
    invocations,     # (M,)
    *,
    sample_bins: int = 50,     # profiler sampling period (bins of dt)
    stale_bins: int = 0,       # RAPL staleness under procfs-scan load
    resident_bins: int = 500,  # keep-alive window: a container stays
                               # "resident" (and receives an even share)
                               # this long after its last activity
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """Faithful Scaphandre-like direct attribution (paper §3.1, §6.1).

    Degradations modeled, as in the reference:
    - CPU (RAPL) power only — non-CPU draw (disk/network) is invisible;
    - coarse sampling: one reading per ``sample_bins`` fine bins, attributed
      over that whole window;
    - stale readings under load: the reading lags by ``stale_bins``;
    - per-*container* even split: kept-alive (resident but idle) containers
      receive the same share as running ones within the window.
    """
    dev = resolve_device(device)
    act_all = _f32(activity, dev)
    chip = _f32(chip_power, dev)
    t, m = act_all.shape
    n_s = t // sample_bins
    blocks = act_all[: n_s * sample_bins].reshape(n_s, sample_bins, m).sum(dim=1)
    # Residency: active within the trailing keep-alive window.
    ever = torch.cumsum((blocks > 0).to(torch.int32), dim=0)
    win = resident_bins // sample_bins
    if win < n_s:
        lagged = torch.cat([act_all.new_zeros((win, m)), ever[:-win].to(torch.float32)])
    else:
        lagged = torch.zeros_like(ever, dtype=torch.float32)
    resident = (ever.to(torch.float32) - lagged) > 0
    # Stale power reading for each sample window.
    shift = stale_bins // max(sample_bins, 1)
    p_win = chip[: n_s * sample_bins].reshape(n_s, sample_bins).mean(dim=1)
    idx = torch.clamp(torch.arange(n_s, device=dev) - shift, 0, n_s - 1)
    p_stale = p_win[idx]
    # Even split over resident containers.
    n_res = resident.sum(dim=1, keepdim=True)
    share = resident.to(torch.float32) / torch.clamp(n_res, min=1).to(torch.float32)
    energy = (share * p_stale[:, None]).sum(dim=0) * sample_bins * dt
    return energy / torch.clamp(_f32(invocations, dev), min=1.0)


def model_only_attribution(
    c_matrix,        # (N, M) runtime contributions per window
    delta: float,
    watts_per_busy,  # scalar or (M,): modeled dynamic watts when busy
    mean_latency,    # (M,) unused, kept for the reference's signature
    invocations,     # (M,)
    *,
    device: str | torch.device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """PowerAPI-like per-invocation energy from a pure utilization model:
    ``sum_windows C[:, j] * watts_per_busy``, never consulting the measured
    system power, so any model bias goes uncorrected."""
    dev = resolve_device(device)
    energy_per_fn = _f32(c_matrix, dev).sum(dim=0) * _f32(watts_per_busy, dev)
    return energy_per_fn / torch.clamp(_f32(invocations, dev), min=1.0)
