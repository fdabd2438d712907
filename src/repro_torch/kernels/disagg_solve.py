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

import torch

from repro_torch.kernels.build import check_launch, load_library, stream_of

_fn = None  # the loaded C entry point, set by ``build``


def build() -> str:
    """Compile the kernel if needed and load it.  Returns nvcc's output
    (register and shared-memory use from ``-Xptxas -v``), or "" when the
    library was already built or loaded."""
    global _fn
    if _fn is not None:
        return ""
    lib, log = load_library("disagg_gram")
    fn = lib.disagg_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return log


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: (gram (..., M, M), rhs (..., M)) = (C^T C, C^T W) in fp32.

    ``c`` is (..., N, M) and ``w`` (..., N) on one CUDA device, any float
    type (cast to fp32, made contiguous, leading dims flattened into the
    kernel's batch axis G).
    """
    if c.device.type != "cuda" or w.device != c.device:
        raise ValueError(
            f"disagg_gram launches a CUDA kernel: c and w must be on one CUDA "
            f"device, got {c.device} and {w.device} (the CPU path is "
            "kernels.ops.disagg_gram)"
        )
    if c.ndim < 2 or tuple(w.shape) != tuple(c.shape[:-1]):
        raise ValueError(f"need c (..., N, M) and w (..., N); got {tuple(c.shape)}, {tuple(w.shape)}")
    if not (c.is_floating_point() and w.is_floating_point()):
        raise ValueError(f"disagg_gram takes floating inputs; got {c.dtype}, {w.dtype}")
    lead, (n, m) = tuple(c.shape[:-2]), tuple(c.shape[-2:])
    c3 = c.to(torch.float32).reshape(-1, n, m).contiguous()
    w2 = w.to(torch.float32).reshape(-1, n).contiguous()
    g = c3.shape[0]
    if max(g, n, m) >= 2**31:
        raise ValueError(f"disagg_gram sizes must fit int32; got G={g}, N={n}, M={m}")
    gram = torch.empty((g, m, m), dtype=torch.float32, device=c.device)
    rhs = torch.empty((g, m), dtype=torch.float32, device=c.device)
    if g and m:
        build()
        with torch.cuda.device(c.device):
            err = _fn(
                c3.data_ptr(), w2.data_ptr(), gram.data_ptr(), rhs.data_ptr(),
                g, n, m, stream_of(c),
            )
        check_launch("disagg_gram", err)
        disagg_gram.launches += 1
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
