"""Public entry points for the compute hot-spots, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch — there is no fallback on the card); a CPU tensor goes to the plain
version in ``ref.py``.  The reference's ``REPRO_FORCE_KERNELS`` override has
no twin: nothing can send a CUDA tensor to the plain version.  Signatures
are the reference's (``repro/kernels/ops.py``).

``flash_attention`` is differentiable, as the reference's is through the
``custom_vjp`` of its ``ref.flash_attention``: when autograd records (grad
enabled and an input requiring grad), it runs as an autograd Function whose
forward is the hand kernel with its log-sum-exp store (CUDA) or
``ref.flash_fwd`` (CPU) and whose backward is ``ref.flash_bwd`` on either
device.  Without a gradient it takes the forward alone and keeps nothing.
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


class _FlashAttention(torch.autograd.Function):
    """The twin of the reference's ``custom_vjp`` (``_flash_fwd`` /
    ``_flash_bwd``): the forward saves (q, k, v, out, lse), the backward
    recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block):
        if _on_cuda("flash_attention", q):
            b, s, h, _ = q.shape
            hkv = k.shape[2]
            lse = torch.empty((b, hkv, h // hkv, s), dtype=torch.float32, device=q.device)
            out = fa.flash_attention(q, k, v, causal=causal, lse=lse)
        else:
            out, lse = ref.flash_fwd(q, k, v, causal, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ref.flash_bwd(q, k, v, out, lse, dout, *ctx.blocks), None, None, None)


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
    ``kv_block``; the plain versions (``flash_fwd``, and ``flash_bwd`` on
    every device) block by them, as the reference does.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_block, kv_block)
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
