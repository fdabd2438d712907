"""CUDA decode attention: one query token per sequence against a KV cache.

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/decode_attention.py::decode_attention``).  The source is
``csrc/decode_attention.cu``, built for ``sm_90a`` at first use by
``kernels/build.py`` and bound through ``ctypes``; nothing is compiled at
import time.  ``decode_attention`` launches the kernel on CUDA tensors and
raises on anything else; ``kernels.ops.decode_attention`` sends CPU tensors
to the plain version.  Its ``launches`` attribute counts kernel launches,
``launches_lse`` those with the log-sum-exp store.

One call is one launch.  The kernel streams each sequence's cache through a
4-stage ``cp.async`` ring of K/V tiles in their stored type, up to the
sequence's length; the reference's ``kv_block`` has no meaning here.  With
few (sequence, KV head) pairs, a pair's cache is cut into slices worked by
the blocks of one thread-block cluster, which merge their softmax states
through distributed shared memory in the same launch (``decode_plan``).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, sm_count, stream_of

#: Head dims the kernel is built for: the configs' 16 (reduced), 64, 112
#: (zamba2's heads, read unpadded) and 128, and 32.
HEAD_DIMS = (16, 32, 64, 112, 128)
# Geometry of csrc/decode_attention.cu (the C side computes the same).
THREADS, WARPS, STAGES = 256, 8, 4
STAGE_TARGET = 16384  # bytes of K + V in one ring stage
MAX_TILE = 128        # keys in one ring stage, at most
MAX_GROUP = 8         # query heads one block serves
MAX_CLUSTER = 8       # blocks in a cluster: the portable limit
MIN_SLICE_TILES = 2   # a slice of the cache is at least this many tiles
BLOCKS_PER_SM = 1     # blocks the split aims for, per streaming multiprocessor
_fns: dict | None = None  # dtype, "smem_bytes", "tile_keys" -> loaded C entry point, set by ``build``


def key_lanes(d: int, elem: int) -> int:
    """Lanes that share a key: one 16-byte piece of the row each, rounded
    up to a power of two (16 at d = 112 in bf16, two of them idle)."""
    return 1 << (d * elem // 16 - 1).bit_length()


def tile_keys(d: int, elem: int) -> int:
    """Keys per ring stage at head_dim ``d`` and element size ``elem``:
    ``STAGE_TARGET`` bytes of K and V, at most ``MAX_TILE`` keys, a
    multiple of the keys the warps take at once."""
    step = WARPS * (32 // key_lanes(d, elem))
    return min(MAX_TILE, STAGE_TARGET // (2 * d * elem)) // step * step


def head_chunks(g: int) -> tuple[int, int, int]:
    """(chunks, heads per chunk, register group): the G query heads of a KV
    head split into as few chunks of at most ``MAX_GROUP`` as will do; the
    kernel sizes its registers for the group, a power of two."""
    nchunk = -(-g // MAX_GROUP)
    gchunk = -(-g // nchunk)
    return nchunk, gchunk, 1 << (gchunk - 1).bit_length()


def smem_bytes(d: int, elem: int, group: int) -> int:
    """The kernel's dynamic shared memory: the ring, the warps' and the
    block's fp32 softmax states (rounded to 16 bytes), the stages' mbarriers."""
    ring = STAGES * 2 * tile_keys(d, elem) * d * elem
    part = -(-(WARPS + 1) * group * (d + 2) * 4 // 16) * 16
    return ring + part + 8 * STAGES


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, h: int, hkv: int, s_max: int, d: int, elem: int, sms: int) -> types.MappingProxyType:
    """The launch for q (b, h, d) against a cache of ``s_max`` rows of
    ``elem``-byte elements on a card of ``sms`` SMs.

    Each (sequence, KV head, head chunk) gets a cluster of ``cluster``
    blocks, a power of two of at most ``MAX_CLUSTER``, each block a slice
    of ``chunk`` keys (a multiple of the tile): enough clusters to give
    about ``BLOCKS_PER_SM`` blocks per SM, no slice shorter than
    ``MIN_SLICE_TILES`` tiles, and one block per pair where the pairs
    already fill the card.
    """
    if d not in HEAD_DIMS or hkv <= 0 or h % hkv or elem not in (2, 4):
        raise ValueError(f"no decode plan for H={h}, Hkv={hkv}, d={d}, element size {elem}")
    tk = tile_keys(d, elem)
    nchunk, gchunk, group = head_chunks(h // hkv)
    pairs = max(b * hkv * nchunk, 1)
    want = -(-BLOCKS_PER_SM * sms // pairs)
    cap = max(1, min(MAX_CLUSTER, want, s_max // (MIN_SLICE_TILES * tk)))
    splits = 1 << (cap.bit_length() - 1)
    chunk = -(-max(s_max, 1) // splits)
    chunk = -(-chunk // tk) * tk
    return types.MappingProxyType(dict(  # cached: read-only
        grid=(splits, hkv * nchunk, b), cluster=splits, chunk=chunk, tile=tk, stages=STAGES,
        threads=THREADS, head_chunks=nchunk, heads_per_block=gchunk, group=group,
        smem_bytes=smem_bytes(d, elem, group),
    ))


def build() -> str:
    """Compile the kernel if needed and load it; returns nvcc's output, or
    "" when it was already built or loaded."""
    global _fns
    if _fns is not None:
        return ""
    lib, log = load_library("decode_attention")
    fns = {}
    for dtype, sym in ((torch.float32, "decode_attention_f32"), (torch.bfloat16, "decode_attention_bf16")):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    for key, sym, nargs in (("smem_bytes", "decode_attention_smem_bytes", 3),
                            ("tile_keys", "decode_attention_tile_keys", 2)):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_int] * nargs
        fn.restype = ctypes.c_int
        fns[key] = fn
    _fns = fns
    return log


def kernel_geometry(d: int, elem: int, group: int) -> tuple[int, int]:
    """The built kernel's own (tile keys, dynamic shared memory bytes)."""
    build()
    return int(_fns["tile_keys"](elem, d)), int(_fns["smem_bytes"](elem, d, group))


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor, *,
    lse: torch.Tensor | None = None,
) -> torch.Tensor:
    """CUDA kernel: q (B, H, d), caches (B, S, Hkv, d), lengths (B,) int32
    -> (B, H, d), attending to cache rows ``[0, lengths[b])`` only.

    One element type for q and the caches (float32 or bfloat16), d in
    ``HEAD_DIMS``, H a multiple of Hkv, all on one CUDA device.  ``lse``,
    if given, is a contiguous (B, H) float32 tensor on that device that the
    same launch fills with each row's natural log-sum-exp of its scaled
    scores (-inf for a sequence of length 0); the output is the same with
    or without it.
    """
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B,H,d) and caches (B,S,Hkv,d); got {tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k_cache.shape)} do not form GQA heads")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be (B,) int32; got {tuple(lengths.shape)} {lengths.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention takes one of float32/bfloat16; got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention supports head_dim in {HEAD_DIMS}; got {d}")
    if max(b, s_max, h) >= 2**31 or b >= 2**16 or h >= 2**16:
        raise ValueError(f"decode_attention sizes out of range: B={b}, S={s_max}, H={h}")
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev or lengths.device != dev:
        raise ValueError(
            "decode_attention launches a CUDA kernel: q, the caches and lengths must be on one "
            f"CUDA device, got {q.device}, {k_cache.device}, {v_cache.device}, {lengths.device} "
            "(the CPU path is kernels.ops.decode_attention)"
        )
    if lse is not None and (tuple(lse.shape) != (b, h) or lse.dtype != torch.float32 or lse.device != dev
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, h)} tensor on {dev}; "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    q, k_cache, v_cache, lengths = (
        kernel_input(x, "decode_attention") for x in (q, k_cache, v_cache, lengths)
    )
    out = torch.empty_like(q)
    if b and h:
        plan = decode_plan(b, h, hkv, s_max, d, q.element_size(), sm_count(dev))
        build()
        args = (
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s_max, h, hkv, d, plan["cluster"], plan["chunk"], plan["head_chunks"],
            plan["heads_per_block"], 1.0 / float(d) ** 0.5, stream_of(q),
        )
        if dev.index == torch.cuda.current_device():
            err = _fns[q.dtype](*args)
        else:
            with torch.cuda.device(dev):
                err = _fns[q.dtype](*args)
        check_launch("decode_attention", err)
        decode_attention.launches += 1
        decode_attention.launches_lse += lse is not None
    return out


decode_attention.launches = 0
decode_attention.launches_lse = 0  # the launches that stored lse (counted in ``launches`` too)
