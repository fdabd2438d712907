"""CUDA flash attention (forward): blocked online-softmax GQA for prefill.

The Hopper twin of the reference's Pallas kernel
(``repro/kernels/flash_attention.py::flash_attention``), in two variants
that the wrapper picks between by dtype and head_dim before any launch:

- ``"tc"``  -- bf16 at d in {64, 128} (every full-width config): the
  tensor-core kernel ``csrc/flash_attention_tc.cu`` (wgmma products, TMA
  copies into a 3-stage K/V ring, a producer warp and two consumer
  warpgroups per 128-row tile);
- ``"fma"`` -- fp32 at any d, and bf16 at d in {16, 32}: the FMA kernel
  ``csrc/flash_attention.cu`` (64 x 64 tiles, fp32 FMAs).

Both are built for ``sm_90a`` at first use by ``kernels/build.py`` and bound
through ``ctypes``; nothing is compiled at import time.
``flash_attention`` launches one of them on CUDA tensors and raises on
anything else (nothing picks the FMA kernel after the other one fails);
``kernels.ops.flash_attention`` sends CPU tensors to the plain version.
Its ``launches`` attribute counts every launch, ``launches_tc`` the
tensor-core ones.  Neither kernel pads: ragged
S and T are masked inside.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, kernel_input, load_library, stream_of

HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)
# Tiling of the tensor-core kernel (csrc/flash_attention_tc.cu mirrors these).
TC_BQ, TC_BK, TC_STAGES, TC_THREADS, TC_PANEL = 128, 128, 3, 384, 64
_TC_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled", -2: "cuTensorMapEncodeTiled refused a tensor map"}
_fns: dict | None = None  # variant, dtype -> loaded C entry point, set by ``build``


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
    q_bytes = (d // TC_PANEL) * TC_BQ * panel_bytes
    kv_bytes = (d // TC_PANEL) * TC_BK * panel_bytes

    def tensor_map(seq, heads, rows):
        return dict(dims=(d, heads, seq, b), strides=(2 * d, 2 * d * heads, 2 * d * heads * seq),
                    box=(TC_PANEL, 1, rows, 1))

    return dict(
        grid=(nq, h, b), threads=TC_THREADS,
        smem_bytes=q_bytes + 2 * TC_STAGES * kv_bytes + 1024,  # + slack to align to 1024
        key_tiles=tiles[::-1],  # in launch order: the longest query tiles first
        maps=dict(q=tensor_map(s, h, TC_BQ), k=tensor_map(t, hkv, TC_BK), v=tensor_map(t, hkv, TC_BK)),
    )


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    lib_tc.flash_attention_tc_smem_bytes.argtypes = [ctypes.c_int]
    lib_tc.flash_attention_tc_smem_bytes.restype = ctypes.c_int
    fns["tc_smem_bytes"] = lib_tc.flash_attention_tc_smem_bytes
    _fns = fns
    return log + log_tc


def tc_smem_bytes(d: int) -> int:
    """The built tensor-core kernel's own dynamic shared memory at ``d``."""
    build()
    return int(_fns["tc_smem_bytes"](d))


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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """CUDA kernel: q (B, S, H, d), k/v (B, T, Hkv, d) -> (B, S, H, d).

    One element type for all three (float32 or bfloat16), d in
    {16, 32, 64, 128}, H a multiple of Hkv, all on one CUDA device.  fp32
    statistics; the causal mask is offset by T - S; a query row with no live
    key gives 0.  ``variant`` picks the kernel.
    """
    kind = check_args(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention launches a CUDA kernel: q, k and v must be on one CUDA device, "
            f"got {q.device}, {k.device}, {v.device} (the CPU path is kernels.ops.flash_attention)"
        )
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    q, k, v = (kernel_input(x, "flash_attention") for x in (q, k, v))
    out = torch.empty_like(q)
    if b and s and t:
        build()
        with torch.cuda.device(q.device):
            err = _fns[(kind, q.dtype)](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, h, hkv, d, int(causal), 1.0 / float(d) ** 0.5, stream_of(q),
            )
        if err in _TC_ERRORS:
            raise RuntimeError(f"flash_attention tensor-core kernel: {_TC_ERRORS[err]}")
        check_launch(f"flash_attention ({kind})", err)
        flash_attention.launches += 1
        if kind == "tc":
            flash_attention.launches_tc += 1
    elif b and s:
        out.zero_()  # no keys: every row is fully masked, as the kernel would give
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
