"""CUDA decode attention: one query token per sequence against a KV cache.

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/decode_attention.py::decode_attention``).  The source is
``csrc/decode_attention.cu``, built for ``sm_90a`` at first use by
``kernels/build.py`` and bound through ``ctypes``; nothing is compiled at
import time.  ``decode_attention`` launches the kernel on CUDA tensors and
raises on anything else; ``kernels.ops.decode_attention`` sends CPU tensors
to the plain version.  Its ``launches`` attribute counts kernel launches.

The kernel streams the cache in 64-key tiles up to each sequence's length;
the reference's ``kv_block`` has no meaning here.  With few (sequence, KV
head) pairs the cache is split into slices worked by separate blocks and
merged by a second kernel (``split_plan``); one call of the wrapper is one
counted launch either way.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, stream_of

HEAD_DIMS = (16, 32, 64, 128)
TILE = 64             # keys per tile staged by the kernel
MIN_SLICE = 2 * TILE  # shortest slice of the cache a block is given
BLOCKS_PER_SM = 2     # blocks the split aims for, per streaming multiprocessor
_fns: dict | None = None  # dtype -> loaded C entry point, set by ``build``


def split_plan(b: int, hkv: int, s_max: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): cut each (sequence, KV head)'s cache of ``s_max``
    rows into slices of ``chunk`` keys (a multiple of the tile, at least
    ``MIN_SLICE``) until the grid has about ``BLOCKS_PER_SM * sms`` blocks."""
    want = max(1, -(-BLOCKS_PER_SM * sms // max(b * hkv, 1)))
    chunk = -(-s_max // want)
    chunk = max(MIN_SLICE, -(-chunk // TILE) * TILE)
    return max(1, -(-s_max // chunk)), chunk


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    _fns = fns
    return log


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """CUDA kernel: q (B, H, d), caches (B, S, Hkv, d), lengths (B,) int32
    -> (B, H, d), attending to cache rows ``[0, lengths[b])`` only.

    One element type for q and the caches (float32 or bfloat16), d in
    {16, 32, 64, 128}, H a multiple of Hkv, all on one CUDA device.
    """
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in (k_cache, v_cache, lengths)):
        raise ValueError(
            "decode_attention launches a CUDA kernel: q, the caches and lengths must be on one "
            f"CUDA device, got {q.device}, {k_cache.device}, {v_cache.device}, {lengths.device} "
            "(the CPU path is kernels.ops.decode_attention)"
        )
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"need q (B,H,d) and caches (B,S,Hkv,d); got {tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k_cache.shape)} do not form GQA heads")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be (B,) int32; got {tuple(lengths.shape)} {lengths.dtype}")
    dts = (q.dtype, k_cache.dtype, v_cache.dtype)
    if q.dtype not in (torch.float32, torch.bfloat16) or len(set(dts)) != 1:
        raise ValueError(f"decode_attention takes one of float32/bfloat16; got {dts}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention supports head_dim in {HEAD_DIMS}; got {d}")
    if max(b, s_max, h) >= 2**31 or b >= 2**16:
        raise ValueError(f"decode_attention sizes out of range: B={b}, S={s_max}, H={h}")
    q, k_cache, v_cache, lengths = (
        kernel_input(x, "decode_attention") for x in (q, k_cache, v_cache, lengths)
    )
    out = torch.empty_like(q)
    if b and h:
        splits, chunk = split_plan(b, hkv, s_max, torch.cuda.get_device_properties(dev).multi_processor_count)
        slots = b * hkv * splits * (h // hkv) if splits > 1 else 1
        part_acc = torch.empty(slots * d, dtype=torch.float32, device=dev)
        part_ml = torch.empty(2 * slots, dtype=torch.float32, device=dev)
        build()
        with torch.cuda.device(dev):
            err = _fns[q.dtype](
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                b, s_max, h, hkv, d, splits, chunk, 1.0 / float(d) ** 0.5, stream_of(q),
            )
        check_launch("decode_attention", err)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
