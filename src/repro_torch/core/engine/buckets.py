"""Bucket stage: a small table of shapes for serving.

Length buckets make mid-stream admission and extreme-rag fleets cheap: init
blocks and segment packs are padded up to a power-of-two table of lengths.
Zero-pad rows add exactly zero to gram/rhs sums and fully masked pad steps
freeze the filter, so bucketed results stay pinned to the monolithic pack.

The reference buckets to bound its jit compiles.  The port has no jit
cache; the buckets still bound the shapes that the gram kernel, cuBLAS and
the caching allocator see, and reclaim the padded work of a monolithic
ragged pack (``pad_waste_frac`` against ``bucketed_pad_waste``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.disaggregation import solve_nnls_gram
from repro_torch.core.engine.estimate import _node_init_gram
from repro_torch.core.engine.packing import pack_fleet_inputs
from repro_torch.core.engine.segment import run_fleet
from repro_torch.core.engine.types import EngineConfig, FleetInputs, FleetResult, Tensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device, stage

#: Default length-bucket table, shared by the init solves (window counts)
#: and the segment packs (step counts).  Powers of two: each bucket at most
#: doubles the padded work.
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that fits a length-``n`` block.

    Lengths beyond the table round up to the next power of two, so the
    mapping is total.  ``n`` must be positive (a zero-length block has no
    bucket).
    """
    if n <= 0:
        raise ValueError(f"bucket_for needs a positive length, got {n}")
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    return 1 << (int(n) - 1).bit_length()


def _bucket_init_solve(c_pad: Tensor, w_pad: Tensor, config: EngineConfig) -> Tensor:
    """One node's gram-domain NNLS over a bucket-padded init block.  Zero
    padding is exact here: the gram/rhs are sums over window rows and a zero
    row adds exactly zero to both."""
    gram, rhs = _node_init_gram(c_pad, w_pad)
    eye = config.init_lam * torch.eye(c_pad.shape[-1], dtype=c_pad.dtype, device=c_pad.device)
    return solve_nnls_gram(gram + eye, rhs, iters=config.init_iters)


def _pad_rows(x: Tensor, rows: int) -> Tensor:
    """Zero-pad axis 0 of ``x`` to ``rows``."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def bucketed_initial_estimate(
    c,
    w,
    config: EngineConfig = EngineConfig(),
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    device: str | torch.device = DEFAULT_DEVICE,
) -> Tensor:
    """(M,) X_0 for ONE node over a length-bucketed init block (§4.2, serving).

    The serving twin of ``fleet_initial_estimate``: an (n, M) block ``c``
    and its (n,) power ``w`` are zero-padded to ``bucket_for(n)`` windows,
    their gram and rhs formed by one flat matmul each (``_node_init_gram``,
    as the reference does, outside any kernel) and solved by
    ``solve_nnls_gram``.  The estimate equals the unpadded solve up to float
    reassociation of the row reduction.

    Host arrays are padded on the host and cross to ``device`` in one
    non-blocking copy from pinned memory, so an admission never waits on
    the card; the estimate stays there.
    """
    dev = resolve_device(device)
    c = torch.as_tensor(c, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32)
    n, m = c.shape
    bkt = bucket_for(n, buckets)
    c, w = _pad_rows(c, bkt), _pad_rows(w, bkt)
    if c.device.type == "cpu" and dev.type == "cuda":
        block = stage(torch.cat([c, w[:, None]], dim=1), dev)
        c, w = block[:, :m], block[:, m]
    else:
        c, w = c.to(dev), w.to(dev)
    return _bucket_init_solve(c, w, config)


def warm_bucket_solvers(
    num_fns: int,
    config: EngineConfig = EngineConfig(),
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    device: str | torch.device = DEFAULT_DEVICE,
) -> int:
    """Run the bucketed init solve once at every bucket's shape.

    The reference pre-compiles one jit per bucket here.  The port has no jit
    cache; the function stays for the API, and one solve per shape leaves
    the caching allocator and the cuBLAS workspaces warm before a pool
    serves.  Returns the number of buckets run."""
    dev = resolve_device(device)
    for n in buckets:
        _bucket_init_solve(
            torch.zeros((n, num_fns), device=dev), torch.zeros((n,), device=dev), config
        )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return len(buckets)


class FleetBucket(NamedTuple):
    """One length bucket of a bucketed fleet pack (``pack_fleet_buckets``).

    ``inputs`` is a normal (len(nodes), steps, n_w, ...) ``FleetInputs``
    block padded to the bucket's step count ``steps``."""

    inputs: FleetInputs
    nodes: tuple          # original fleet indices packed into this bucket
    lengths: tuple        # their real per-node window counts
    steps: int            # bucket step count (the block's shape)


def pad_waste_frac(lengths, step_windows: int, *, s: int | None = None) -> float:
    """Fraction of engine ticks that are padding in a single (B, s, n_w) pack.

    ``pack_fleet_inputs`` pads every node to ``s = max_i S_i`` steps; on an
    extreme-rag fleet most ticks are masked padding.  ``s`` overrides the
    pack's step count.  Compare with ``bucketed_pad_waste``."""
    lens = np.asarray(lengths, np.int64)
    s_nodes = lens // step_windows
    s = int(s_nodes.max()) if s is None else int(s)
    if s == 0:
        raise ValueError("no node has a full step; nothing to pack")
    real = int(np.minimum(s_nodes, s).sum()) * step_windows
    return float(1.0 - real / (s * step_windows * len(lens)))


def bucketed_pad_waste(buckets: "list[FleetBucket]", step_windows: int) -> float:
    """Overall padding fraction across a bucketed pack's groups: each
    node's real full-step ticks over the sum of the buckets' padded shapes,
    which is what the engines compute over."""
    real = total = 0
    for bk in buckets:
        s_nodes = np.minimum(np.asarray(bk.lengths, np.int64) // step_windows, bk.steps)
        real += int(s_nodes.sum()) * step_windows
        total += len(bk.nodes) * bk.steps * step_windows
    return float(1.0 - real / total)


def _pad_steps(inputs: FleetInputs, s_to: int) -> FleetInputs:
    """Pad a packed block to ``s_to`` steps with fully masked zero steps."""
    b, s, n_w, m = inputs.c.shape
    if s >= s_to:
        return inputs
    pad = lambda x: torch.cat(  # noqa: E731
        [x, x.new_zeros((b, s_to - s) + tuple(x.shape[2:]))], dim=1
    )
    mask = inputs.mask if inputs.mask is not None else inputs.w.new_ones((b, s, n_w))
    return FleetInputs(
        c=pad(inputs.c), w=pad(inputs.w), a=pad(inputs.a),
        lat_sum=pad(inputs.lat_sum), lat_sumsq=pad(inputs.lat_sumsq),
        mask=pad(mask), fn_mask=inputs.fn_mask,
    )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_fleet_buckets(
    c_windows,
    w_windows,
    a_windows,
    lat_sum_w,
    lat_sumsq_w,
    *,
    step_windows: int,
    lengths,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    device: str | torch.device = DEFAULT_DEVICE,
) -> "list[FleetBucket]":
    """Length-bucketed fleet packing: reclaim ``pad_waste_frac`` on extreme rag.

    Nodes are grouped by ``bucket_for`` of their full-step count, and each
    group packs (``pack_fleet_inputs``, on ``device``) to its *bucket's* step
    count, padded with fully masked steps so the block's shape is exactly
    the bucket.  Within a group the mask machinery applies unchanged, so
    results match the monolithic pack per node.  Returns one
    ``FleetBucket`` per occupied bucket, ascending by step count; run them
    with ``run_fleet_bucketed``.
    """
    arrs = [_host(x) for x in (c_windows, w_windows, a_windows, lat_sum_w, lat_sumsq_w)]
    b = arrs[0].shape[0]
    lens = np.asarray(lengths, np.int64)
    if lens.shape != (b,):
        raise ValueError(f"lengths must have shape ({b},), got {lens.shape}")
    s_nodes = lens // step_windows
    if int(s_nodes.max()) == 0:
        raise ValueError(
            f"need at least step_windows={step_windows} windows on at "
            f"least one node, got lengths {lens.tolist()}"
        )
    groups: dict[int, list[int]] = {}
    for i, s_i in enumerate(s_nodes):
        groups.setdefault(bucket_for(max(int(s_i), 1), buckets), []).append(i)

    out = []
    for bkt_s in sorted(groups):
        idx = groups[bkt_s]
        need = bkt_s * step_windows

        def take(arr):
            sub = arr[idx]
            if sub.shape[1] < need:
                pad = np.zeros((len(idx), need - sub.shape[1]) + sub.shape[2:], sub.dtype)
                sub = np.concatenate([sub, pad], axis=1)
            return np.asarray(sub[:, :need], np.float32)

        # A node's sub-step tail feeds no update; clamp its length to the
        # bucket span so the group block never needs the tail windows.
        grp_lens = [min(int(lens[i]), need) for i in idx]
        packed = pack_fleet_inputs(
            *[take(a) for a in arrs], step_windows=step_windows, lengths=grp_lens,
            device=device,
        )
        out.append(
            FleetBucket(
                inputs=_pad_steps(packed, bkt_s),
                nodes=tuple(idx),
                lengths=tuple(int(lens[i]) for i in idx),
                steps=bkt_s,
            )
        )
    return out


def run_fleet_bucketed(
    buckets: "list[FleetBucket]",
    config: EngineConfig = EngineConfig(),
    *,
    engine=None,
    with_ticks: bool = False,
) -> tuple[Tensor, Tensor, "list[FleetResult]"]:
    """Run every bucket of a bucketed pack and stitch estimates to fleet order.

    ``engine`` is any segment engine (``run_fleet`` by default,
    ``run_fleet_gram`` — the gram kernel on the card, at each bucket's
    shapes — or ``run_fleet_stream``), run on the device the buckets lie on.
    Per-node math is node-independent, so scattering each group's rows back
    by its original indices reproduces the monolithic pack's estimates (up
    to the batch size's reassociation; pinned at 1e-5 of scale).

    Returns ``(x_final, x0, results)``: (B, M) stitched estimates on that
    device plus the per-bucket results in the order of ``buckets``.
    """
    engine = run_fleet if engine is None else engine
    dev = buckets[0].inputs.c.device
    b_total = 1 + max(max(bk.nodes) for bk in buckets)
    m = buckets[0].inputs.c.shape[-1]
    x_final = torch.zeros((b_total, m), device=dev)
    x0 = torch.zeros((b_total, m), device=dev)
    results = []
    for bk in buckets:
        res = engine(bk.inputs, config, with_ticks=with_ticks, device=dev)
        rows = torch.as_tensor(bk.nodes, dtype=torch.int64).to(dev)
        x_final.index_copy_(0, rows, res.x_final)
        x0.index_copy_(0, rows, res.x0)
        results.append(res)
    return x_final, x0, results
