"""Step counters: the accelerator analogue of perf counters (paper §4.3).

The paper's CPU model consumes UNHALTED_CYCLES / LLC_MISSES /
INSTRUCTIONS_RETIRED per function, normalized by the system-wide totals.
Our invocation classes carry (FLOPs, HBM bytes) per invocation plus busy
time.  Features per interval (F = 3): [gflop rate, hbm GB rate, duty cycle],
each normalized exactly like the paper normalizes counters.

Both builders are *fleet-shaped*: they accept one node's ``(N, M)``
contribution matrix or a whole fleet's ``(B, N, M)`` stack and emit the
``(B, N, F)`` / ``(B, M, F)`` feature batches the combined-mode paths
consume, in float32 on the contribution matrix's device.  A ragged fleet
passes its ``(..., N)`` tick-validity ``mask``: padded windows are zeroed
before any reduction, so junk past a node's real span feeds neither the
per-window features nor the per-function normalization totals.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

NUM_FEATURES = 3


def _prep(c_matrix, mean_latency, mask):
    c = torch.as_tensor(c_matrix, dtype=torch.float32)
    lat = torch.clamp(torch.as_tensor(mean_latency, dtype=torch.float32, device=c.device), min=1e-6)
    if mask is not None:
        c = c * torch.as_tensor(mask, dtype=c.dtype, device=c.device)[..., None]
    return c, lat


def window_counters(
    c_matrix,             # (..., N, M) seconds of runtime per window
    gflops,               # (M,) per invocation
    hbm_gb,               # (M,)
    mean_latency,         # (M,)
    delta: float,
    *,
    mask=None,            # (..., N) window validity; None = all real
) -> Tensor:
    """(..., N, F) system-wide counter features per window.

    Works per node (``(N, M)`` in, ``(N, F)`` out) or fleet-batched
    (``(B, N, M)`` in, ``(B, N, F)`` out) in one call; masked (padded)
    windows produce all-zero feature rows.
    """
    c, lat = _prep(c_matrix, mean_latency, mask)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=c.device)
    gflop_rate = f32(gflops) / lat   # GFLOP/s while running
    hbm_rate = f32(hbm_gb) / lat
    feats = torch.stack(
        [
            c @ gflop_rate,              # GFLOPs in window
            c @ hbm_rate,                # HBM GB in window
            torch.sum(c, dim=-1),        # busy seconds in window
        ],
        dim=-1,
    )
    return feats / delta


def function_counters(
    c_matrix,             # (..., N, M)
    gflops,               # (M,)
    hbm_gb,               # (M,)
    mean_latency,         # (M,)
    *,
    mask=None,            # (..., N) window validity; None = all real
) -> Tensor:
    """(..., M, F) per-function counters normalized by system totals (the
    paper's 'function counters / system-wide counters' scheme).

    Fleet-batched input normalizes each node by its *own* totals; masked
    windows contribute to neither the numerators nor the totals.
    """
    c, lat = _prep(c_matrix, mean_latency, mask)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=c.device)
    busy = torch.sum(c, dim=-2)                           # (..., M) seconds
    rates = torch.stack([f32(gflops) / lat, f32(hbm_gb) / lat, torch.ones_like(lat)], dim=-1)  # (M, F)
    per_fn = busy[..., None] * rates                      # (..., M, F)
    totals = torch.clamp(torch.sum(per_fn, dim=-2, keepdim=True), min=1e-9)
    return per_fn / totals
