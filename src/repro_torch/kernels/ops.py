"""Public entry points for the compute hot-spots, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch — there is no fallback on the card); a CPU tensor goes to the plain
version in ``ref.py``.  The reference's ``REPRO_FORCE_KERNELS`` override has
no twin: nothing can send a CUDA tensor to the plain version.  Signatures
are the reference's (``repro/kernels/ops.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import disagg_solve as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} has no path for device {x.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blocked GQA attention (B, S, H, d) x (B, T, Hkv, d) -> (B, S, H, d).

    The CUDA kernel chooses its own tiles and ignores ``q_block`` and
    ``kv_block``; the plain version blocks by them, as the reference does.
    """
    if _on_cuda("flash_attention", q):
        return fa.flash_attention(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal, q_block, kv_block)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    kv_block: int = 2048,
) -> torch.Tensor:
    """Single-token GQA attention against a KV cache: (B, H, d).  The CUDA
    kernel streams its own K/V tiles and ignores ``kv_block``; so does the
    plain version, which is unblocked like the reference's."""
    if _on_cuda("decode_attention", q):
        return da.decode_attention(q, k_cache, v_cache, lengths.to(torch.int32))
    return ref.decode_attention(q, k_cache, v_cache, lengths)


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched normal-equation assembly (C^T C, C^T W) for the fleet solve."""
    if _on_cuda("disagg_gram", c):
        return ds.disagg_gram(c, w)
    return ref.disagg_gram(c, w)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm (CUDA kernel) / plain version (CPU)."""
    if _on_cuda("rmsnorm", x):
        return rn.rmsnorm(x, gamma, eps)
    return ref.rmsnorm(x, gamma, eps)
