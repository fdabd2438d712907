"""Power de-noising and time-skew synchronization (paper §5, Eq. 5, Fig. 5).

System-level power sources (IPMI/BMC, plug meters) lag the workload by up to
seconds.  FaasMeter estimates the skew

    s* = argmin_s  sum_t ( W(t+s)/W_mean - R(t)/R_mean )^2        (Eq. 5)

against a "real-time" reference R (chip power), both mean-normalized.  As
in the reference, every candidate integer shift is evaluated in one
vectorized gather + reduction, then refined sub-sample with a parabolic fit
around the minimum.  ``torch.argmin`` returns the first minimum, as
``jnp.argmin`` does, so exact ties resolve the same way; a near-tie can
still flip the skew by a whole window when the two backends round the chi^2
sums differently.
"""

from __future__ import annotations

import torch


def _chi2_per_shift(w: torch.Tensor, r: torch.Tensor, max_shift: int) -> torch.Tensor:
    """chi^2(s) for s in [-max_shift, +max_shift] (in samples)."""
    wn = w / torch.clamp(torch.mean(w), min=1e-12)
    rn = r / torch.clamp(torch.mean(r), min=1e-12)
    n = w.shape[0]
    shifts = torch.arange(-max_shift, max_shift + 1, device=w.device)
    idx = torch.arange(n, device=w.device)[None, :] + shifts[:, None]   # (2S+1, n)
    valid = ((idx >= 0) & (idx < n)).to(w.dtype)
    d2 = (wn[torch.clamp(idx, 0, n - 1)] - rn[None, :]) ** 2 * valid
    return torch.sum(d2, dim=1) / torch.clamp(torch.sum(valid, dim=1), min=1.0)


def estimate_skew(w: torch.Tensor, r: torch.Tensor, *, max_shift: int = 16) -> torch.Tensor:
    """Estimate the lag of ``w`` behind ``r`` in (fractional) samples.

    Positive result: ``w`` is delayed and must be advanced by that much.
    Returns a float32 scalar tensor on ``w``'s device.
    """
    chi = _chi2_per_shift(w, r, max_shift)
    i = torch.argmin(chi)
    # Parabolic refinement over (i-1, i, i+1); clamp at the grid edge.
    im = torch.clamp(i - 1, 0, 2 * max_shift)
    ip = torch.clamp(i + 1, 0, 2 * max_shift)
    y0, y1, y2 = chi[im], chi[i], chi[ip]
    denom = y0 - 2.0 * y1 + y2
    ok = torch.abs(denom) > 1e-12
    frac = torch.where(ok, 0.5 * (y0 - y2) / torch.where(ok, denom, 1.0), 0.0)
    frac = torch.clamp(frac, -0.5, 0.5)
    interior = (i > 0) & (i < 2 * max_shift)
    return (i - max_shift).to(torch.float32) + torch.where(interior, frac, 0.0)


def apply_shift(w: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Advance ``w`` by ``shift`` samples with linear interpolation.

    Edge samples are held (zero-order) rather than extrapolated.
    """
    n = w.shape[0]
    pos = torch.arange(n, dtype=torch.float32, device=w.device) + shift
    pos = torch.clamp(pos, 0.0, n - 1.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = pos - lo
    return w[lo] * (1.0 - frac) + w[hi] * frac


def synchronize(
    w: torch.Tensor, r: torch.Tensor, *, max_shift: int = 16
) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate skew of ``w`` vs reference ``r`` and return (w_aligned, skew)."""
    skew = estimate_skew(w, r, max_shift=max_shift)
    return apply_shift(w, skew), skew


def denoise_median3(w: torch.Tensor) -> torch.Tensor:
    """3-tap median pre-filter for spiky plug-meter samples, along the
    first axis, the edges replicated."""
    prev = torch.cat([w[:1], w[:-1]])
    nxt = torch.cat([w[1:], w[-1:]])
    return torch.median(torch.stack([prev, w, nxt]), dim=0).values
