"""Contribution matrices C and A (paper §4.1).

The key disaggregation parameter is the "function contribution to power"
matrix ``C`` with shape (N windows, M functions): ``C[i, j]`` is the total
time (seconds) that invocations of function ``j`` were running during window
``i``.  ``A[i, j]`` counts invocations ("activations") of ``j`` starting in
window ``i``.

Invocation traces are flat tensors ``(fn_id, start, end)``; ``fn_id < 0``
entries are padding and contribute nothing.  Results land on the device of
the trace tensors.

Exact overlap is computed with the *cumulative running-time* identity:

    F_j(t)  = sum_k min(max(t - s_k, 0), e_k - s_k)   over invocations k of j
    C[i, j] = F_j(t_{i+1}) - F_j(t_i)

evaluated at the N+1 window edges, in float32 as in the reference.  A
chunked loop over invocations bounds peak memory at (chunk, N+1).  Over a
long trace the cumulative curves reach ~10^3 s, and float32 cancellation
between neighbouring edges then leaves ~1e-4 s of absolute noise per cell.

Float sums over a trace are taken on the host, in a fixed order: CUDA's
``index_add_`` adds floats atomically, in an order that changes from run to
run, and the Kalman solver amplifies such last-bit differences.  A trace on
the card is copied to the host and its matrix back, so the card gets the
CPU's bits.
"""

from __future__ import annotations

import torch

_CHUNK = 1024  # invocations per loop step; bounds peak memory at (CHUNK, N+1)


def _pad_to_multiple(x: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    return torch.cat([x, x.new_full((rem,), fill)])


def contribution_matrix(
    fn_id: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    *,
    num_fns: int,
    num_windows: int,
    t0: float = 0.0,
    delta: float = 1.0,
) -> torch.Tensor:
    """Exact (N, M) running-time contribution matrix.

    Args:
      fn_id: (K,) int function ids; negative ids are padding.
      start, end: (K,) float32 invocation start/end times (seconds).
      num_fns: M, total number of unique functions (matrix width).
      num_windows: N, number of measurement windows.
      t0: left edge of window 0.
      delta: window length in seconds (paper default: 1 s).

    Returns:
      (N, M) float32 matrix of seconds-of-runtime per window per function,
      summed on the host and returned on the trace's device.
    """
    dev = start.device
    edges = t0 + delta * torch.arange(num_windows + 1, dtype=torch.float32)
    edges64 = edges.double()
    fn_id = _pad_to_multiple(fn_id.cpu().to(torch.int64), _CHUNK, -1)
    start = _pad_to_multiple(start.cpu().to(torch.float32), _CHUNK, 0.0)
    end = _pad_to_multiple(end.cpu().to(torch.float32), _CHUNK, 0.0)
    acc = torch.zeros((num_fns + 1, num_windows + 1), dtype=torch.float32)
    for lo in range(0, fn_id.shape[0], _CHUNK):
        cid = fn_id[lo : lo + _CHUNK]
        valid = cid >= 0
        if not bool(valid.any()):
            continue
        cs = start[lo : lo + _CHUNK]
        dur = torch.clamp(end[lo : lo + _CHUNK] - cs, min=0.0)
        seg = torch.where(valid, cid, num_fns)  # padding -> overflow row, dropped
        # Per-chunk segment sum, then one add: the reference's order.  An
        # invocation's cumulative running time is exactly 0 at the edges up
        # to its start and exactly its duration from start + duration on,
        # so the chunk's sums are 0 left of its first start (adding 0 leaves
        # ``acc`` as it is) and, right of its last start + duration, the
        # same sum of durations at every edge: only the edges between are
        # summed column by column.  The bits are those of the full sum.
        s64, d64 = cs[valid].double(), dur[valid].double()
        c_lo = int(torch.searchsorted(edges64, s64.min(), right=True))
        c_hi = int(torch.searchsorted(edges64, (s64 + d64).max()))
        if c_hi > c_lo:
            # (CHUNK, c_hi - c_lo) cumulative running time at those edges.
            f = torch.clamp(edges[None, c_lo:c_hi] - cs[:, None], min=0.0)
            torch.minimum(f, dur[:, None], out=f)
            acc[:, c_lo:c_hi] += torch.zeros((num_fns + 1, c_hi - c_lo)).index_add_(0, seg, f)
        if c_hi <= num_windows:
            acc[:, max(c_hi, c_lo):] += torch.zeros(num_fns + 1).index_add_(0, seg, dur)[:, None]
    cum = acc[:num_fns]  # (M, N+1)
    return (cum[:, 1:] - cum[:, :-1]).T.contiguous().to(dev)  # (N, M)


def invocation_counts(
    fn_id: torch.Tensor,
    start: torch.Tensor,
    *,
    num_fns: int,
    num_windows: int,
    t0: float = 0.0,
    delta: float = 1.0,
) -> torch.Tensor:
    """(N, M) activation-count matrix A: invocations *starting* per window.

    Computed where the trace lies: the sums add ones, exact in float32
    below 2^24 in any order, so CUDA's atomic adds cannot change a bit.
    """
    idx = torch.floor((start - t0) / delta).to(torch.int64)
    in_range = (idx >= 0) & (idx < num_windows) & (fn_id >= 0)
    w = torch.clamp(idx, 0, num_windows - 1)
    f = torch.clamp(fn_id.to(torch.int64), 0, num_fns - 1)
    counts = torch.zeros(num_windows * num_fns, dtype=torch.float32, device=start.device)
    counts.index_add_(0, w * num_fns + f, in_range.to(torch.float32))
    return counts.reshape(num_windows, num_fns)


def activity_series(
    fn_id: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    *,
    num_fns: int,
    num_bins: int,
    t0: float = 0.0,
    dt: float = 0.01,
) -> torch.Tensor:
    """(T, M) concurrent-invocation counts on a fine time grid, float32,
    on the device of the trace.

    Event-based: +1 at the bin containing ``start``, -1 at the bin
    containing ``end`` (each dropped outside the grid, and both for
    ``fn_id < 0``), with invocations that start before ``t0`` but end
    inside the grid seeding the first bin, cumulative-summed along time.
    The sums add small integers, exact in float32 in any order, so CUDA's
    atomic adds cannot change a bit.  The simulator keeps its own numpy
    twin (``telemetry.simulator._activity_numpy``) for the bitwise
    telemetry chain.
    """
    sbin = torch.floor((start.to(torch.float32) - t0) / dt).to(torch.int64)
    ebin = torch.floor((end.to(torch.float32) - t0) / dt).to(torch.int64)
    valid = fn_id >= 0
    f = torch.clamp(fn_id.to(torch.int64), 0, num_fns - 1)
    events = torch.zeros(num_bins * num_fns, dtype=torch.float32, device=start.device)
    for bins, sign in ((sbin, 1.0), (ebin, -1.0)):
        ok = valid & (bins >= 0) & (bins < num_bins)
        events.index_add_(0, torch.clamp(bins, 0, num_bins - 1) * num_fns + f, ok.to(torch.float32) * sign)
    before = valid & (sbin < 0) & (ebin >= 0)
    events[:num_fns].index_add_(0, f, before.to(torch.float32))
    return torch.cumsum(events.reshape(num_bins, num_fns), dim=0)


def shared_principal_contribution(
    principal_cpu_frac: torch.Tensor,
    system_cpu_frac: torch.Tensor,
    *,
    delta: float = 1.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Paper Eq. 2: normalized shared-principal contribution column.

        c_cp = (control-plane CPU% / system-wide CPU%) * delta

    Both inputs are (N,) per-window utilization fractions in [0, 1+].
    """
    ratio = principal_cpu_frac / torch.clamp(system_cpu_frac, min=eps)
    return torch.clamp(ratio, 0.0, 1.0) * delta


def augment_with_principals(c_matrix: torch.Tensor, *principal_cols: torch.Tensor) -> torch.Tensor:
    """Append shared-principal columns (control plane, OS, ...) to C (§4.1)."""
    return torch.cat([c_matrix] + [p[:, None] for p in principal_cols], dim=1)
