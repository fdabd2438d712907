"""CUDA flash attention (forward): blocked online-softmax GQA for prefill.

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/flash_attention.py::flash_attention``).  The source is
``csrc/flash_attention.cu``, built for ``sm_90a`` at first use by
``kernels/build.py`` and bound through ``ctypes``; nothing is compiled at
import time.  ``flash_attention`` launches the kernel on CUDA tensors and
raises on anything else; ``kernels.ops.flash_attention`` sends CPU tensors
to the plain version.  Its ``launches`` attribute counts kernel launches.

The kernel chooses its own tiles (64 query rows x 64 keys) and pads
nothing: ragged S and T are masked inside it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, stream_of

HEAD_DIMS = (16, 32, 64, 128)
_fns: dict | None = None  # dtype -> loaded C entry point, set by ``build``


def build() -> str:
    """Compile the kernel if needed and load it; returns nvcc's output, or
    "" when it was already built or loaded."""
    global _fns
    if _fns is not None:
        return ""
    lib, log = load_library("flash_attention")
    fns = {}
    for dtype, sym in ((torch.float32, "flash_attention_f32"), (torch.bfloat16, "flash_attention_bf16")):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    _fns = fns
    return log


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """CUDA kernel: q (B, S, H, d), k/v (B, T, Hkv, d) -> (B, S, H, d).

    One element type for all three (float32 or bfloat16), d in
    {16, 32, 64, 128}, H a multiple of Hkv, all on one CUDA device.  fp32
    statistics; the causal mask is offset by T - S.
    """
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention launches a CUDA kernel: q, k and v must be on one CUDA device, "
            f"got {q.device}, {k.device}, {v.device} (the CPU path is kernels.ops.flash_attention)"
        )
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
    q, k, v = (kernel_input(x, "flash_attention") for x in (q, k, v))
    out = torch.empty_like(q)
    if b and s and t:
        build()
        with torch.cuda.device(q.device):
            err = _fns[q.dtype](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, h, hkv, d, int(causal), 1.0 / float(d) ** 0.5, stream_of(q),
            )
        check_launch("flash_attention", err)
        flash_attention.launches += 1
    elif b and s:
        out.zero_()  # no keys: every row is fully masked, as the kernel would give
    return out


flash_attention.launches = 0
