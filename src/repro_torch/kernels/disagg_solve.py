"""CUDA kernel for the paper's core computation at fleet scale: batched
normal-equation assembly for the disaggregation solve (Eq. 1).

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/disagg_solve.py::disagg_gram``).  The source is
``csrc/disagg_gram.cu``; it is compiled for ``sm_90a`` with ``nvcc`` at
first use into ``kernels/build/`` by ``kernels/build.py`` (a
content-hashed ``.so``, so an edited source is rebuilt) and bound through
``ctypes``.  Nothing is compiled or loaded at import time: the CPU tests
import this module on machines with no ``nvcc``.

``disagg_gram`` launches the kernel on CUDA tensors and raises on anything
else; the device dispatch that sends CPU tensors to the plain version is
``kernels.ops.disagg_gram``.  Its ``launches`` attribute counts kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, sm_count, stream_of

# Geometry of csrc/disagg_gram.cu (the C side takes what ``gram_plan`` says).
SMALL_M_MAX = 16       # the warp variant's largest M; above it the tiled one
WARP_MAX_N = 1024      # the warp variant's longest N: one warp walks all N rows of its batch entry
WARP_STAGE_FLOATS = 1024  # C floats one warp stages per chunk (at most 256 rows)
WARP_MAX_ROWS = 256
MAX_WARPS = 8          # warps per block of the warp variant
BLOCKS_PER_SM = 2      # the warp variant's grid, at most, per SM
SLAB_ROWS = 16         # rows of C per shared-memory slab of the tiled variant
TILED_WARPS_PER_SM = 24  # warps the tiled variant's N split aims for, per SM
MAX_CLUSTER = 8        # blocks in a cluster: the portable limit
_fn = None  # the loaded C entry point, set by ``build``


def variant(m: int, n: int) -> str:
    """The kernel variant that serves (N x M) blocks: ``"warp"`` (one warp
    per batch entry) up to ``SMALL_M_MAX`` columns and ``WARP_MAX_N`` rows,
    ``"tiled"`` (register-tiled SYRK, N split across a cluster) otherwise."""
    return "warp" if m <= SMALL_M_MAX and n <= WARP_MAX_N else "tiled"


def upper_tiles(m: int, tile: int) -> list[tuple[int, int]]:
    """The (row, column) tiles on or above the diagonal, in launch order
    (blockIdx.z of the tiled variant)."""
    t = -(-m // tile)
    return [(i, j) for i in range(t) for j in range(i, t)]


@functools.lru_cache(maxsize=256)
def gram_plan(g: int, n: int, m: int, sms: int) -> types.MappingProxyType:
    """The launch for G blocks of (N x M) on a card of ``sms`` SMs.

    ``warp``: ``warps`` warps a block (fewer when G is small, so that the
    batch spreads over the SMs), ``blocks`` blocks (a grid-stride loop past
    ``BLOCKS_PER_SM`` per SM), chunks of ``rows`` rows.
    ``tiled``: ``tile`` x ``tile`` output tiles (32 up to M = 128, then
    64) on or above the diagonal, each thread a 4 x 4 block; where G x
    tiles gives fewer than ``TILED_WARPS_PER_SM`` warps per SM, N is split
    into ``splits`` slices of ``rows`` rows (a multiple of the slab), one
    cluster of ``splits`` blocks per tile.
    """
    if min(g, n, m) < 1:
        raise ValueError(f"no gram plan for G={g}, N={n}, M={m}")
    if variant(m, n) == "warp":
        rows = min(n, WARP_MAX_ROWS, max(1, WARP_STAGE_FLOATS // m))
        warps = max(1, min(MAX_WARPS, -(-g // sms)))
        blocks = min(-(-g // warps), BLOCKS_PER_SM * sms)
        buf = -(-(rows * m + 4) // 4) * 4 + -(-(rows + 4) // 4) * 4
        return types.MappingProxyType(dict(  # cached: read-only
            variant="warp", grid=(blocks,), threads=32 * warps, warps=warps, rows=rows,
            chunks=-(-n // rows), tile=0, splits=1, smem_bytes=4 * warps * 2 * buf))
    tile = 32 if m <= 128 else 64
    tiles = upper_tiles(m, tile)
    warps = (tile // 4) ** 2 // 32
    want = -(-TILED_WARPS_PER_SM * sms // (g * len(tiles) * warps))
    cap = max(1, min(MAX_CLUSTER, want, n // (4 * SLAB_ROWS)))
    splits = 1 << (cap.bit_length() - 1)
    rows = -(-(-(-n // splits)) // SLAB_ROWS) * SLAB_ROWS
    return types.MappingProxyType(dict(
        variant="tiled", grid=(splits, g, len(tiles)), threads=32 * warps, warps=warps, rows=rows,
        chunks=-(-rows // SLAB_ROWS), tile=tile, splits=splits, tiles=tuple(tiles), smem_bytes=0))


def build() -> str:
    """Compile the kernel if needed and load it.  Returns nvcc's output
    (register and shared-memory use from ``-Xptxas -v``), or "" when the
    library was already built or loaded."""
    global _fn
    if _fn is not None:
        return ""
    lib, log = load_library("disagg_gram")
    fn = lib.disagg_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return log


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: (gram (..., M, M), rhs (..., M)) = (C^T C, C^T W) in fp32.

    ``c`` is (..., N, M) and ``w`` (..., N) on one CUDA device, any float
    type (cast to fp32, made contiguous, leading dims flattened into the
    kernel's batch axis G).
    """
    if c.ndim < 2 or tuple(w.shape) != tuple(c.shape[:-1]):
        raise ValueError(f"need c (..., N, M) and w (..., N); got {tuple(c.shape)}, {tuple(w.shape)}")
    if not (c.is_floating_point() and w.is_floating_point()):
        raise ValueError(f"disagg_gram takes floating inputs; got {c.dtype}, {w.dtype}")
    if c.device.type != "cuda" or w.device != c.device:
        raise ValueError(
            f"disagg_gram launches a CUDA kernel: c and w must be on one CUDA "
            f"device, got {c.device} and {w.device} (the CPU path is "
            "kernels.ops.disagg_gram)"
        )
    lead, (n, m) = tuple(c.shape[:-2]), tuple(c.shape[-2:])
    c3 = kernel_input(c.to(torch.float32).reshape(-1, n, m), "disagg_gram")
    w2 = kernel_input(w.to(torch.float32).reshape(-1, n), "disagg_gram")
    g = c3.shape[0]
    if max(g, n, m) >= 2**31:
        raise ValueError(f"disagg_gram sizes must fit int32; got G={g}, N={n}, M={m}")
    gram = torch.empty((g, m, m), dtype=torch.float32, device=c.device)
    rhs = torch.empty((g, m), dtype=torch.float32, device=c.device)
    if g and m and n:
        plan = gram_plan(g, n, m, sm_count(c.device))
        if plan["variant"] == "tiled" and max(g, len(plan["tiles"])) >= 2**16:
            raise ValueError(f"disagg_gram's tiled variant takes G and tile counts below 65536; got G={g}, M={m}")
        build()
        with torch.cuda.device(c.device):
            err = _fn(
                c3.data_ptr(), w2.data_ptr(), gram.data_ptr(), rhs.data_ptr(), g, n, m,
                int(plan["variant"] == "tiled"), plan["grid"][0], plan["warps"], plan["rows"],
                plan["tile"], plan["splits"], stream_of(c),
            )
        check_launch("disagg_gram", err)
        disagg_gram.launches += 1
    elif g and m:
        gram.zero_()
        rhs.zero_()
    return gram.reshape(lead + (m, m)), rhs.reshape(lead + (m,))


disagg_gram.launches = 0


def default_backend(device: torch.device) -> str:
    """Gram-assembly backend for the engine's ``backend="auto"``: the CUDA
    kernel for tensors on the card, the plain einsum elsewhere."""
    return "kernel" if torch.device(device).type == "cuda" else "einsum"


def disagg_solve_nnls(
    c: torch.Tensor, w: torch.Tensor, lam: float = 1e-3, *, iters: int = 200
) -> torch.Tensor:
    """Kernel-assembled NNLS: gram pass + batched gram-domain FISTA.

    (G, N, M) contribution batches in, (G, M) non-negative power estimates
    out, with the window dimension touched exactly once (inside the gram
    pass: the kernel on CUDA, the plain version on the CPU).
    """
    from repro_torch.core.disaggregation import solve_nnls_gram
    from repro_torch.kernels.ops import disagg_gram as gram_dispatch

    gram, rhs = gram_dispatch(c, w)
    m = gram.shape[-1]
    gram = gram + lam * torch.eye(m, dtype=gram.dtype, device=gram.device)
    return solve_nnls_gram(gram, rhs, iters=iters)


def disagg_solve(
    c: torch.Tensor, w: torch.Tensor, lam: float = 1e-3, *, nonneg: bool = True
) -> torch.Tensor:
    """Kernel-assembled ridge solve: Cholesky on the (G, M, M) grams."""
    from repro_torch.kernels.ops import disagg_gram as gram_dispatch

    gram, rhs = gram_dispatch(c, w)
    m = gram.shape[-1]
    gram = gram + lam * torch.eye(m, dtype=gram.dtype, device=gram.device)
    chol = torch.linalg.cholesky(gram)
    x = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    return torch.clamp(x, min=0.0) if nonneg else x
