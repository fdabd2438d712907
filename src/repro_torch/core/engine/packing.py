"""Packing stage: per-window arrays → (B, S, n_w, ...) engine batches.

``pack_fleet_inputs`` is the one place the ragged-fleet pad-and-mask
contract is defined on the way *in*; ``synthetic_fleet`` (step blocks)
and ``synthetic_ragged_windows`` (per-window arrays) are the shared seeded
input factories of the equivalence tests (numpy draws, so the same seed
gives the reference's arrays).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine.types import FleetInputs
from repro_torch.device import DEFAULT_DEVICE, resolve_device


def synthetic_fleet(
    b: int, s: int, n_w: int, m: int, *, seed: int = 0, density: float = 0.2,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetInputs:
    """Randomized synthetic fleet batch: sparse contributions, true power
    plus noise (the reference's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    c = np.abs(rng.standard_normal((b, s, n_w, m))) * (
        rng.random((b, s, n_w, m)) > 1 - density
    )
    x_true = np.abs(rng.standard_normal((b, m))) * 20.0 + 2.0
    w = np.einsum("bsnm,bm->bsn", c, x_true) + 0.1 * rng.standard_normal((b, s, n_w))
    a = (rng.random((b, s, m)) > 0.5) * rng.integers(0, 4, (b, s, m))
    lat = np.abs(rng.standard_normal((b, s, m)))
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return FleetInputs(
        c=f32(c), w=f32(np.maximum(w, 0.0)), a=f32(a),
        lat_sum=f32(lat * a), lat_sumsq=f32(lat**2 * a),
    )


def pack_fleet_inputs(
    c_windows,    # (B, N, M) per-node contribution matrices
    w_windows,    # (B, N) per-node idle-adjusted power
    a_windows,    # (B, N, M) per-node invocation counts
    lat_sum_w,    # (B, N, M) per-window latency sums
    lat_sumsq_w,  # (B, N, M)
    *,
    step_windows: int,
    lengths: Sequence[int] | np.ndarray | None = None,
    fn_lengths: Sequence[int] | np.ndarray | None = None,
    strict: bool = False,
    device: str | torch.device = DEFAULT_DEVICE,
) -> FleetInputs:
    """Group per-window arrays into (B, S, n_w, ...) Kalman-step blocks on
    ``device``, padding + masking ragged fleets instead of truncating them.

    Node ``i`` contributes ``lengths[i]`` real windows and yields
    ``S_i = lengths[i] // step_windows`` steps; the fleet packs to
    ``S = max_i S_i`` steps with a (B, S, n_w) validity mask.  Everything
    outside a node's valid region is zeroed and masked, so junk in the
    padded tail can never leak into grams, innovations, or attribution.  A
    uniform fleet whose window count divides ``step_windows`` packs with
    ``mask=None``.  ``fn_lengths`` sets ``fn_mask`` over a padded function
    axis; ``strict`` requires every node to have all N windows with N a
    multiple of ``step_windows`` and raises otherwise.
    """
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    c_windows, w_windows, a_windows = f32(c_windows), f32(w_windows), f32(a_windows)
    lat_sum_w, lat_sumsq_w = f32(lat_sum_w), f32(lat_sumsq_w)
    b, n, m = c_windows.shape
    if lengths is None:
        lens = np.full((b,), n, np.int64)
    else:
        lens = np.asarray(lengths, np.int64)
        if lens.shape != (b,):
            raise ValueError(f"lengths must have shape ({b},), got {lens.shape}")
        if np.any(lens < 0) or np.any(lens > n):
            raise ValueError(
                f"lengths must lie in [0, {n}] (the padded window axis); "
                f"got {lens.tolist()}"
            )
    if strict and (np.any(lens != n) or n % step_windows != 0):
        raise ValueError(
            f"pack_fleet_inputs(strict=True) requires every node to "
            f"have exactly N={n} windows with N divisible by "
            f"step_windows={step_windows}; got lengths="
            f"{lens.tolist()} (use strict=False for pad-and-mask)"
        )
    s_nodes = lens // step_windows                   # (B,) full steps per node
    s = int(s_nodes.max()) if b else 0
    if s == 0:
        raise ValueError(
            f"need at least step_windows={step_windows} windows on at "
            f"least one node, got lengths {lens.tolist()} (N={n})"
        )
    n_used = s * step_windows
    if n < n_used:
        raise ValueError(f"window axis N={n} shorter than S*n_w={n_used}")
    # Per-node valid region: the first S_i full steps' ticks, nothing else.
    tick_valid = np.arange(n_used)[None, :] < (s_nodes * step_windows)[:, None]
    mask = f32(tick_valid.reshape(b, s, step_windows))
    mv = mask[..., None]
    fn_mask = None
    if fn_lengths is not None:
        fn_lens = np.asarray(fn_lengths, np.int64)
        if fn_lens.shape != (b,):
            raise ValueError(f"fn_lengths must have shape ({b},), got {fn_lens.shape}")
        if np.any(fn_lens < 0) or np.any(fn_lens > m):
            raise ValueError(
                f"fn_lengths must lie in [0, {m}] (the padded function "
                f"axis); got {fn_lens.tolist()}"
            )
        if np.any(fn_lens != m):
            fn_mask = f32(np.arange(m)[None, :] < fn_lens[:, None])
    grp = lambda x: x[:, :n_used].reshape(b, s, step_windows, m)
    return FleetInputs(
        c=grp(c_windows) * mv,
        w=w_windows[:, :n_used].reshape(b, s, step_windows) * mask,
        a=(grp(a_windows) * mv).sum(dim=2),
        lat_sum=(grp(lat_sum_w) * mv).sum(dim=2),
        lat_sumsq=(grp(lat_sumsq_w) * mv).sum(dim=2),
        mask=None if bool(tick_valid.all()) else mask,
        fn_mask=fn_mask,
    )


def synthetic_ragged_windows(
    b: int, n: int, m: int, *, lengths: Sequence[int], seed: int = 0,
    density: float = 0.2, device: str | torch.device = DEFAULT_DEVICE,
):
    """Per-*window* synthetic fleet tensors for ragged packing (the
    reference's generator, draw for draw).

    Returns ``(c, w, a, lat_sum, lat_sumsq)`` of shape (B, N, ...) on
    ``device``, ready for ``pack_fleet_inputs`` with the given ``lengths``.
    Windows past each node's length hold *non-zero junk* on purpose, so the
    pad-and-mask contract (junk never leaks into a result) is exercised,
    not vacuously true.
    """
    rng = np.random.default_rng(seed)
    c = np.abs(rng.standard_normal((b, n, m))) * (rng.random((b, n, m)) > 1 - density)
    x_true = np.abs(rng.standard_normal((b, m))) * 20.0 + 2.0
    w = np.maximum(
        np.einsum("bnm,bm->bn", c, x_true) + 0.1 * rng.standard_normal((b, n)), 0.0
    )
    a = ((rng.random((b, n, m)) > 0.8) * rng.integers(0, 3, (b, n, m))).astype(np.float32)
    lat = np.abs(rng.standard_normal((b, n, m)))
    ls, lq = lat * a, lat**2 * a
    for i, li in enumerate(lengths):
        c[i, li:] = 7.7
        w[i, li:] = 123.0
        a[i, li:] = 3.0
        ls[i, li:] = 9.9
        lq[i, li:] = 9.9
    dev = resolve_device(device)
    return tuple(
        torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (c, w, a, ls, lq)
    )
