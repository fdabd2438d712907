"""CUDA fused RMSNorm: fp32 statistics per row, streamed at the HBM rate.

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/rmsnorm.py::rmsnorm``).  The source is ``csrc/rmsnorm.cu``,
built for ``sm_90a`` at first use by ``kernels/build.py`` and bound through
``ctypes``; nothing is compiled at import time.  ``rmsnorm`` launches the
kernel on CUDA tensors and raises on anything else; ``kernels.ops.rmsnorm``
sends CPU tensors to the plain version.  Its ``launches`` attribute counts
kernel launches.  As in the reference, the models call the plain
``models.common.rms_norm``; this kernel is reached through ``ops.rmsnorm``.

Which loop serves a row (``variant``, as ``csrc/rmsnorm.cu`` chooses):
``"row"`` holds the row in registers (d = 2048 in either type, d = 4096 in
bf16), ``"vector"`` loops over 16-byte vectors, ``"scalar"`` over elements
(rows whose bytes are not a multiple of 16).  Every variant runs on a
persistent grid sized to the card's SM count.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, stream_of

_fns: dict | None = None  # dtype -> loaded C entry point, set by ``build``
ROW_LENGTHS = {torch.bfloat16: (2048, 4096), torch.float32: (2048,)}  # served with the row in registers


def variant(dtype: torch.dtype, d: int) -> str:
    """The loop that serves rows of length ``d``: "row", "vector" or "scalar"."""
    if (d * torch.empty((), dtype=dtype).element_size()) % 16:
        return "scalar"
    return "row" if d in ROW_LENGTHS.get(dtype, ()) else "vector"


def build() -> str:
    """Compile the kernel if needed and load it; returns nvcc's output, or
    "" when it was already built or loaded."""
    global _fns
    if _fns is not None:
        return ""
    lib, log = load_library("rmsnorm")
    fns = {}
    for dtype, sym in ((torch.float32, "rmsnorm_f32"), (torch.bfloat16, "rmsnorm_bf16")):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    _fns = fns
    return log


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """CUDA kernel: x (..., d) float32/bfloat16, gamma (d,) any float type
    (used as fp32) -> x * rsqrt(mean(x^2) + eps) * gamma in x's dtype."""
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(
            f"rmsnorm launches a CUDA kernel: x and gamma must be on one CUDA device, got "
            f"{x.device}, {gamma.device} (the CPU path is kernels.ops.rmsnorm)"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x; got {x.dtype}")
    if x.ndim < 1 or tuple(gamma.shape) != (x.shape[-1],):
        raise ValueError(f"need x (..., d) and gamma (d,); got {tuple(x.shape)}, {tuple(gamma.shape)}")
    d = x.shape[-1]
    if d >= 2**31:
        raise ValueError(f"rmsnorm row length must fit int32; got {d}")
    xf = kernel_input(x, "rmsnorm")
    g32 = kernel_input(gamma.to(torch.float32), "rmsnorm")
    out = torch.empty_like(xf)
    rows = xf.numel() // d if d else 0
    if rows:
        vec = int(variant(x.dtype, d) != "scalar")  # both tensors are 16-byte aligned
        build()
        with torch.cuda.device(x.device):
            err = _fns[x.dtype](
                xf.data_ptr(), g32.data_ptr(), out.data_ptr(), rows, d, float(eps), vec, stream_of(x),
            )
        check_launch("rmsnorm", err)
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
