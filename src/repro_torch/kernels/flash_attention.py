"""CUDA flash attention (forward): blocked online-softmax GQA for prefill.

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/flash_attention.py::flash_attention``), in two variants
that the wrapper picks between by dtype and head_dim before any launch:

- ``"tc"``  -- bf16 at d in {64, 112, 128} (every full-width config): the
  tensor-core kernel ``csrc/flash_attention_tc.cu`` (wgmma products, TMA
  copies into a 3-stage K/V ring, a producer warp and two consumer
  warpgroups per 128-row tile);
- ``"fma"`` -- fp32 at any d, and bf16 at d in {16, 32}: the FMA kernel
  ``csrc/flash_attention.cu`` (IEEE fp32 FFMAs on 128 x 128 tiles, an 8 x 8
  register patch a thread, fed by a 4-stage TMA ring; ``fma_plan`` gives its
  geometry). No TF32: its bound is the CUDA cores' 67 TFLOP/s of fp32 FFMA,
  as the FMA backward's is.

Both are built for ``sm_90a`` at first use by ``kernels/build.py`` and bound
through ``ctypes``; nothing is compiled at import time.
``flash_attention`` launches one of them on CUDA tensors and raises on
anything else (nothing picks the FMA kernel after the other one fails);
``kernels.ops.flash_attention`` sends CPU tensors to the plain version.
Its ``launches`` attribute counts every launch, ``launches_tc`` the
tensor-core ones.  Neither kernel pads: ragged
S and T are masked inside.  Given an ``lse`` buffer (the training path's
forward, ``kernels.ops.flash_attention``'s autograd Function), both kernels
also store each query row's log-sum-exp there, which the backward
recomputes the probabilities from; serving passes none, and the kernels
then store nothing more.

``flash_attention_bwd`` is that backward on the card, the twin of the
reference's ``_flash_bwd`` (``csrc/flash_attention_bwd.cu``: a rowsum
prologue, then a dK/dV pass and a dQ pass, no atomics): where the forward
takes ``"tc"``, both passes run ``wgmma`` fed by TMA rings, as the forward
does (``bwd_plan`` gives their geometry); where it takes ``"fma"``, IEEE
fp32 FFMAs on 64 own rows against 128-row streamed tiles, one warpgroup for
each score product, 8 x 8 register patches, fed by a TMA ring
(``fma_plan``).  It raises on anything it does not take; its
``launches`` attribute counts its calls (three kernels each),
``launches_fma`` the FMA ones.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, stream_of

#: Head dims the kernels are built for: the configs' 16 (reduced), 64, 112
#: (zamba2's heads, computed natively on two 64-column panels) and 128, and 32.
HEAD_DIMS = (16, 32, 64, 112, 128)
TC_HEAD_DIMS = (64, 112, 128)
# Tiling of the tensor-core kernel (csrc/flash_attention_tc.cu mirrors these).
TC_BQ, TC_BK, TC_STAGES, TC_THREADS, TC_PANEL = 128, 128, 3, 384, 64
# Tiling of the backward's tensor-core passes (csrc/flash_attention_bwd.cu
# mirrors these): (own rows a block, streamed rows a stage, ring stages).
BWD_KV_TILES, BWD_Q_TILES, BWD_THREADS = (128, 64, 3), (128, 128, 2), 384
# Tiling of the FMA kernels (csrc/flash_attention.cu and the FMA passes of
# csrc/flash_attention_bwd.cu mirror these): the forward's (query rows a
# block, keys a tile, keys a V chunk) and ring stages, the backward's (own
# rows a block, streamed rows a tile, columns of d a score chunk), and the
# threads of both; ``_fma_bwd_ring`` gives the backward's gradient chunk rows
# and stages.
FMA_FWD_TILES, FMA_STAGES, FMA_BWD_TILES, FMA_THREADS = (128, 128, 32), 4, (64, 128, 16), 256

_MAP_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled", -2: "cuTensorMapEncodeTiled refused a tensor map"}
_fns: dict | None = None  # variant, dtype -> loaded C entry point, set by ``build``
_bwd_fns: dict | None = None  # dtype -> the backward's loaded C entry point, set by ``build_bwd``


def _fma_bwd_ring(d: int, elem: int = 4) -> tuple[int, int]:
    """The FMA backward's (streamed rows of a gradient chunk, ring stages):
    (32, 3), but (16, 4) for fp32 at d 128, where 3 stages of 32 rows would
    not fit beside the own tiles."""
    return (16, 4) if elem == 4 and d == 128 else (32, 3)


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that serves (dtype, head_dim): ``"tc"`` or ``"fma"``."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "fma"


def tc_plan(b: int, s: int, t: int, h: int, hkv: int, d: int, causal: bool = True) -> dict:
    """Host-side geometry of one tensor-core launch, as the C side computes
    it: the grid, the dynamic shared memory, the key tiles the blocks walk,
    and each tensor map's dims (innermost first), byte strides of dims 1..3
    and box."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core kernel serves head_dim in {TC_HEAD_DIMS}; got {d}")
    nq, nk = -(-s // TC_BQ), -(-t // TC_BK)
    tiles = []
    for qt in range(nq):
        q_last = min((qt + 1) * TC_BQ, s) - 1 + t - s
        tiles.append(nk if not causal else (0 if q_last < 0 else min(q_last // TC_BK + 1, nk)))
    panel_bytes = 128  # one 64-column bf16 row of a swizzle panel
    panels = -(-d // TC_PANEL)  # d = 112: two, TMA zero-fills columns 112-127
    q_bytes = panels * TC_BQ * panel_bytes
    kv_bytes = panels * TC_BK * panel_bytes

    def tensor_map(seq, heads, rows):
        return dict(dims=(d, heads, seq, b), strides=(2 * d, 2 * d * heads, 2 * d * heads * seq),
                    box=(TC_PANEL, 1, rows, 1))

    return dict(
        grid=(nq, h, b), threads=TC_THREADS,
        smem_bytes=q_bytes + 2 * TC_STAGES * kv_bytes + 1024,  # + slack to align to 1024
        key_tiles=tiles[::-1],  # in launch order: the longest query tiles first
        maps=dict(q=tensor_map(s, h, TC_BQ), k=tensor_map(t, hkv, TC_BK), v=tensor_map(t, hkv, TC_BK)),
    )


def bwd_plan(b: int, s: int, t: int, h: int, hkv: int, d: int, causal: bool = True) -> dict:
    """Host-side geometry of the backward's tensor-core passes, as the C
    side computes it: for each pass (``"kv"``, the dK/dV pass; ``"q"``, the
    dQ pass) its grid,
    threads, own and streamed tile rows, ring stages, dynamic shared
    memory, and the streamed tiles each block walks in launch order (the
    dK/dV pass counts the G query heads' 64-row query tiles, the dQ pass the
    128-key tiles)."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core backward serves head_dim in {TC_HEAD_DIMS}; got {d}")
    panels = -(-d // TC_PANEL)  # d = 112: two, TMA zero-fills columns 112-127
    offset = t - s

    def smem(own, stream, stages, row_values):
        tile = panels * 128  # bytes of one row of a tile: its panels' 128-byte rows
        return 2 * own * tile + 2 * stages * stream * tile + stages * row_values * 4 + 1024  # + slack to align

    own, stream, stages = BWD_KV_TILES
    nq = -(-s // stream)
    kv_tiles = [(h // hkv) * (nq - (max(kt * own - offset, 0) // stream if causal else 0))
                for kt in range(-(-t // own))]
    kv = dict(grid=(-(-t // own), hkv, b), threads=BWD_THREADS, own_rows=own, stream_rows=stream, stages=stages,
              smem_bytes=smem(own, stream, stages, 2 * stream), tiles=kv_tiles)
    own, stream, stages = BWD_Q_TILES
    nk = -(-t // stream)
    q_tiles = []
    for qt in range(-(-s // own)):
        q_last = min((qt + 1) * own, s) - 1 + offset
        q_tiles.append(nk if not causal else (0 if q_last < 0 else min(q_last // stream + 1, nk)))
    q = dict(grid=(-(-s // own), h, b), threads=BWD_THREADS, own_rows=own, stream_rows=stream, stages=stages,
             smem_bytes=smem(own, stream, stages, 0), tiles=q_tiles[::-1])  # the longest query tiles first
    return dict(kv=kv, q=q)


def _fma_smem_bytes(kind: str, d: int, elem: int = 4) -> int:
    """Dynamic shared memory of one FMA block (``kind`` ``"fwd"`` or
    ``"bwd"``, both backward passes alike) at head_dim ``d`` with
    ``elem``-byte elements, as the C side computes it: the TMA ring's
    stages (1024-byte aligned), the dense Q or own tiles, the fp32
    transposed P (and dS) tiles, room for 4 mbarriers, and 1024 bytes of
    slack to align the base."""
    dp = 128 if d == 112 else d  # the accumulator's 16 lanes x d / 16 columns (8 at d 112)

    def ceil1024(n):
        return -(-n // 1024) * 1024

    if kind == "fwd":
        bq, bk, vr = FMA_FWD_TILES
        w = 32 if d % 32 == 0 else 16  # columns of d a K chunk
        stage = ceil1024(max(bk * w * elem, vr * dp * elem))
        return FMA_STAGES * stage + bq * d * elem + 4 * bk * (bq + 4) + 8 * FMA_STAGES + 1024
    own, stream, aw = FMA_BWD_TILES
    br, stages = _fma_bwd_ring(d, elem)
    part = ceil1024(max(stream * aw * elem, br * dp * elem))  # one warpgroup's part of a chunk
    return stages * 2 * part + 2 * own * d * elem + 2 * 4 * stream * (own + 4) + 32 + 1024


def fma_plan(b: int, s: int, t: int, h: int, hkv: int, d: int, causal: bool = True,
             dtype: torch.dtype = torch.float32) -> dict:
    """Host-side geometry of the FMA kernels, as the C side computes it: for
    the forward (``"fwd"``) and each backward pass (``"kv"``, the dK/dV pass;
    ``"q"``, the dQ pass) its grid (own tiles, heads, batch: launched as one
    dimension, tile-major, every head and batch of a tile before the next
    tile), threads, own and streamed tile rows, ring stages, dynamic shared
    memory, and the streamed tiles each own tile's blocks walk, in launch
    order (the forward and the dQ pass count key tiles up to the causal
    limit, the longest query tiles first; the dK/dV pass counts the G query
    heads' tiles from the first with a live pair)."""
    if variant(dtype, d) != "fma" or d not in HEAD_DIMS:
        raise ValueError(f"the FMA kernels serve fp32 at head_dim in {HEAD_DIMS} and bf16 at 16, 32; "
                         f"got {dtype} at {d}")
    elem = torch.empty((), dtype=dtype).element_size()
    offset = t - s

    def key_tiles(rows, keys):  # per query tile of `rows`, the `keys`-key tiles up to the last live one
        nk, out = -(-t // keys), []
        for qt in range(-(-s // rows)):
            q_last = min((qt + 1) * rows, s) - 1 + offset
            out.append(nk if not causal else (0 if q_last < 0 else min(q_last // keys + 1, nk)))
        return out[::-1]  # the longest query tiles first

    bq, bk, _ = FMA_FWD_TILES
    fwd = dict(grid=(-(-s // bq), h, b), threads=FMA_THREADS, own_rows=bq, stream_rows=bk, stages=FMA_STAGES,
               smem_bytes=_fma_smem_bytes("fwd", d, elem), tiles=key_tiles(bq, bk))
    own, stream, _ = FMA_BWD_TILES
    stages = _fma_bwd_ring(d, elem)[1]
    nq = -(-s // stream)
    kv_tiles = [(h // hkv) * max(nq - (max(kt * own - offset, 0) // stream if causal else 0), 0)
                for kt in range(-(-t // own))]
    smem = _fma_smem_bytes("bwd", d, elem)
    kv = dict(grid=(-(-t // own), hkv, b), threads=FMA_THREADS, own_rows=own, stream_rows=stream,
              stages=stages, smem_bytes=smem, tiles=kv_tiles)
    q = dict(grid=(-(-s // own), h, b), threads=FMA_THREADS, own_rows=own, stream_rows=stream, stages=stages,
             smem_bytes=smem, tiles=key_tiles(own, stream))
    return dict(fwd=fwd, kv=kv, q=q)


def build() -> str:
    """Compile both kernels if needed and load them; returns nvcc's output,
    or "" when they were already built or loaded."""
    global _fns
    if _fns is not None:
        return ""
    lib, log = load_library("flash_attention")
    lib_tc, log_tc = load_library("flash_attention_tc")
    fns = {}
    for key, fn in ((("fma", torch.float32), lib.flash_attention_f32),
                    (("fma", torch.bfloat16), lib.flash_attention_bf16),
                    (("tc", torch.bfloat16), lib_tc.flash_attention_tc_bf16)):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    lib_tc.flash_attention_tc_smem_bytes.argtypes = [ctypes.c_int]
    lib_tc.flash_attention_tc_smem_bytes.restype = ctypes.c_int
    fns["tc_smem_bytes"] = lib_tc.flash_attention_tc_smem_bytes
    lib.flash_attention_fma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_fma_smem_bytes.restype = ctypes.c_int
    fns["fma_smem_bytes"] = lib.flash_attention_fma_smem_bytes
    _fns = fns
    return log + log_tc


def build_bwd() -> str:
    """Compile the backward's kernels if needed and load them, apart from
    the forward's (serving never needs them); returns nvcc's output, or ""
    when they were already built or loaded."""
    global _bwd_fns
    if _bwd_fns is not None:
        return ""
    lib, log = load_library("flash_attention_bwd")
    fns = {}
    for dtype, fn in ((torch.float32, lib.flash_attention_bwd_f32), (torch.bfloat16, lib.flash_attention_bwd_bf16)):
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.flash_attention_bwd_tc_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_bwd_tc_smem_bytes.restype = ctypes.c_int
    fns["tc_smem_bytes"] = lib.flash_attention_bwd_tc_smem_bytes
    lib.flash_attention_fma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_fma_smem_bytes.restype = ctypes.c_int
    fns["fma_smem_bytes"] = lib.flash_attention_fma_smem_bytes
    _bwd_fns = fns
    return log


def tc_smem_bytes(d: int) -> int:
    """The built tensor-core kernel's own dynamic shared memory at ``d``."""
    build()
    return int(_fns["tc_smem_bytes"](d))


def bwd_smem_bytes(d: int) -> tuple[int, int]:
    """The built backward's dynamic shared memory at ``d``: (dK/dV pass, dQ pass)."""
    build_bwd()
    return int(_bwd_fns["tc_smem_bytes"](d, 0)), int(_bwd_fns["tc_smem_bytes"](d, 1))


def fma_smem_bytes(d: int, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """The built FMA kernels' dynamic shared memory at ``d`` in ``dtype``:
    (forward, either backward pass); 0 where the pair is not served."""
    build()
    build_bwd()
    elem = torch.empty((), dtype=dtype).element_size()
    return int(_fns["fma_smem_bytes"](d, elem)), int(_bwd_fns["fma_smem_bytes"](d, elem))


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Raise on shapes, dtypes or head_dims no kernel takes; return the
    variant that serves them.  Devices are checked by the caller."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,S,H,d) and k, v (B,T,Hkv,d); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not form GQA heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes one of float32/bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head_dim in {HEAD_DIMS}; got {d}")
    if max(b, s, t, h) >= 2**31 or b >= 2**16 or h >= 2**16:
        raise ValueError(f"flash_attention sizes out of range: B={b}, S={s}, T={t}, H={h}")
    return variant(q.dtype, d)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, lse: torch.Tensor | None = None
) -> torch.Tensor:
    """CUDA kernel: q (B, S, H, d), k/v (B, T, Hkv, d) -> (B, S, H, d).

    One element type for all three (float32 or bfloat16), d in
    ``HEAD_DIMS``, H a multiple of Hkv, all on one CUDA device.  fp32
    statistics; the causal mask is offset by T - S; a query row with no live
    key gives 0.  ``variant`` picks the kernel.  ``lse``, if given, is a
    contiguous fp32 (B, Hkv, H // Hkv, S) tensor on q's device that receives
    each row's log-sum-exp ``m + log(max(l, 1e-30))`` of the scaled scores
    (-1e30 for a row with no live key), as the reference's ``_flash_fwd``
    returns it.
    """
    kind = check_args(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention launches a CUDA kernel: q, k and v must be on one CUDA device, "
            f"got {q.device}, {k.device}, {v.device} (the CPU path is kernels.ops.flash_attention)"
        )
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if lse is not None and (lse.shape != (b, hkv, h // hkv, s) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, hkv, h // hkv, s)} tensor on {q.device}; "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    q, k, v = (kernel_input(x, "flash_attention") for x in (q, k, v))
    out = torch.empty_like(q)
    if b and s and t:
        build()
        with torch.cuda.device(q.device):
            err = _fns[(kind, q.dtype)](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                b, s, t, h, hkv, d, int(causal), 1.0 / float(d) ** 0.5, stream_of(q),
            )
        if err in _MAP_ERRORS:
            raise RuntimeError(f"flash_attention ({kind}) kernel: {_MAP_ERRORS[err]}")
        check_launch(f"flash_attention ({kind})", err)
        flash_attention.launches += 1
        if kind == "tc":
            flash_attention.launches_tc += 1
    elif b and s:
        out.zero_()  # no keys: every row is fully masked, as the kernel would give
        if lse is not None:
            lse.fill_(-1e30)
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    *, causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CUDA kernels: (dq, dk, dv) of ``flash_attention`` in the inputs' dtype.

    ``out`` and ``lse`` are the forward's (its lse store: contiguous fp32
    (B, Hkv, H // Hkv, S)), ``dout`` the output's gradient, (B, S, H, d)
    like ``out``; all in q's dtype and on q's CUDA device, the shapes and
    head dims ``flash_attention`` takes.  fp32 accumulators; a query row
    with no live key gets zero gradient.  No atomics: the same inputs give
    the same bits.
    """
    kind = check_args(q, k, v)
    tensors = (q, k, v, out, lse, dout)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(
            f"flash_attention_bwd launches CUDA kernels: its inputs must be on one CUDA device, got "
            f"{[str(x.device) for x in tensors]} (the CPU path is kernels.ops.flash_attention)"
        )
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype} {tuple(q.shape)} like q; got {out.dtype} "
                         f"{tuple(out.shape)}, {dout.dtype} {tuple(dout.shape)}")
    if lse.shape != (b, hkv, h // hkv, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, hkv, h // hkv, s)} tensor; "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    q, k, v, out, dout = (kernel_input(x, "flash_attention_bwd") for x in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b and s and t:
        dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)  # rowsum(dO * O)
        build_bwd()
        with torch.cuda.device(q.device):
            err = _bwd_fns[q.dtype](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, s, t, h, hkv, d, int(causal), 1.0 / float(d) ** 0.5, stream_of(q),
            )
        if err in _MAP_ERRORS:
            raise RuntimeError(f"flash_attention_bwd ({kind}) kernels: {_MAP_ERRORS[err]}")
        check_launch(f"flash_attention_bwd ({kind})", err)
        flash_attention_bwd.launches += 1
        if kind == "fma":
            flash_attention_bwd.launches_fma += 1
    else:  # no query or no key: nothing is attended, every gradient is 0
        for x in (dq, dk, dv):
            x.zero_()
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_fma = 0
