"""Public entry points for the compute hot-spots, dispatched by device, and
the hand kernels as ``torch.library`` custom ops.

A CUDA tensor goes to the hand-written kernel's custom op (which raises if
it cannot launch -- there is no fallback on the card); a CPU tensor goes to
the plain version in ``ref.py``.  The reference's ``REPRO_FORCE_KERNELS``
override has no twin: nothing can send a CUDA tensor to the plain version.
Signatures are the reference's (``repro/kernels/ops.py``).

**Custom ops.**  Each kernel is an operator of the ``repro_torch``
namespace -- ``flash_attention``, ``flash_attention_lse``,
``flash_attention_bwd``, ``decode_attention``, ``decode_attention_lse``,
``rmsnorm``, ``disagg_gram`` -- whose CUDA
implementation is its wrapper's launch (``flash_attention.py``,
``decode_attention.py``, ``rmsnorm.py``, ``disagg_solve.py``) and whose fake
implementation gives the output shapes and dtypes alone, touching no
library.  So a trace on fake tensors (``launch.dryrun``) reaches the ops as
the card's program does, without building or launching anything, and
``torch.utils.flop_counter.FlopCounterMode`` counts the attention ops by
``launch.costs._attn_score_flops``'s convention (2 x 2 x queries x keys x
H x d, halved when causal; the backward 2.5 times that, its five
products), so that the counter and the cost model agree.
A fake tensor reaches the op on any device: torch built without CUDA
cannot run autograd on fake CUDA tensors, so a dry run there traces on fake
CPU tensors, and those too go to the op, never to the plain version.

``flash_attention`` is differentiable, as the reference's is through the
``custom_vjp`` of its ``ref.flash_attention``: when autograd records (grad
enabled and an input requiring grad), it runs as an autograd Function whose
forward is the ``flash_attention_lse`` op (the kernel with its log-sum-exp
store) and whose backward is the ``flash_attention_bwd`` op (the backward
kernels) wherever the forward took the op, or ``ref.flash_fwd`` then
``ref.flash_bwd`` for a real CPU tensor.  Without a gradient it takes the
forward alone and keeps nothing.
"""

from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import disagg_solve as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn

_lib = torch.library.Library("repro_torch", "DEF")
_lib.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
_lib.define("flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal) -> (Tensor, Tensor)")
_lib.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, bool causal)"
            " -> (Tensor, Tensor, Tensor)")
_lib.define("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths) -> Tensor")
_lib.define("decode_attention_lse(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths) -> (Tensor, Tensor)")
_lib.define("rmsnorm(Tensor x, Tensor gamma, float eps) -> Tensor")
_lib.define("disagg_gram(Tensor c, Tensor w) -> (Tensor, Tensor)")


def _flash_lse(q, k, v, causal):
    b, s, h, _ = q.shape
    hkv = k.shape[2]
    lse = torch.empty((b, hkv, h // hkv, s), dtype=torch.float32, device=q.device)
    return fa.flash_attention(q, k, v, causal=causal, lse=lse), lse


def _decode_lse(q, k_cache, v_cache, lengths):
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return da.decode_attention(q, k_cache, v_cache, lengths, lse=lse), lse


# Each CUDA implementation looks its wrapper up at call time.
_lib.impl("flash_attention", lambda q, k, v, causal: fa.flash_attention(q, k, v, causal=causal), "CUDA")
_lib.impl("flash_attention_lse", _flash_lse, "CUDA")
_lib.impl("flash_attention_bwd", lambda q, k, v, out, lse, dout, causal: fa.flash_attention_bwd(
    q, k, v, out, lse, dout, causal=causal), "CUDA")
_lib.impl("decode_attention", lambda q, kc, vc, lengths: da.decode_attention(q, kc, vc, lengths), "CUDA")
_lib.impl("decode_attention_lse", _decode_lse, "CUDA")
_lib.impl("rmsnorm", lambda x, gamma, eps: rn.rmsnorm(x, gamma, eps=eps), "CUDA")
_lib.impl("disagg_gram", lambda c, w: ds.disagg_gram(c, w), "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_lib)
def _flash_fake(q, k, v, causal):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flash_attention_lse", lib=_lib)
def _flash_lse_fake(q, k, v, causal):
    b, s, h, _ = q.shape
    hkv = k.shape[2]
    return torch.empty_like(q), q.new_empty((b, hkv, h // hkv, s), dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_attention_bwd", lib=_lib)
def _flash_bwd_fake(q, k, v, out, lse, dout, causal):
    # The gradients as the CUDA implementation allocates them: contiguous.
    # Its scratch is left out: the (B, H, S) fp32 rowsum (2 / d of dq's
    # bytes in bf16) and a contiguous copy of a strided input live only
    # inside the call, and the dry run's tracker sees an op's outputs alone.
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v))


@torch.library.register_fake("repro_torch::decode_attention", lib=_lib)
def _decode_fake(q, k_cache, v_cache, lengths):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::decode_attention_lse", lib=_lib)
def _decode_lse_fake(q, k_cache, v_cache, lengths):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


@torch.library.register_fake("repro_torch::rmsnorm", lib=_lib)
def _rmsnorm_fake(x, gamma, eps):
    return torch.empty_like(x)


@torch.library.register_fake("repro_torch::disagg_gram", lib=_lib)
def _gram_fake(c, w):
    lead, m = tuple(c.shape[:-2]), c.shape[-1]
    return c.new_empty(lead + (m, m), dtype=torch.float32), c.new_empty(lead + (m,), dtype=torch.float32)


def attention_flops(b: int, s: int, t: int, h: int, d: int, causal: bool) -> int:
    """Score and PV contractions of ``b x s`` queries against ``t`` keys
    over ``h`` heads of ``d``: ``launch.costs._attn_score_flops``'s
    convention (causal halves the keys)."""
    return 2 * 2 * b * s * t * h * d // (2 if causal else 1)


@register_flop_formula([torch.ops.repro_torch.flash_attention, torch.ops.repro_torch.flash_attention_lse])
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs) -> int:
    b, s, h, d = q_shape
    return attention_flops(b, s, k_shape[1], h, d, causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal, *args, out_shape=None,
                     **kwargs) -> int:
    """The backward's five products (the recomputed Q K^T, dO V^T, dS K,
    dS^T Q, P^T dO): 2.5 x the forward's two, whatever a kernel recomputes."""
    b, s, h, d = q_shape
    return 5 * attention_flops(b, s, k_shape[1], h, d, causal) // 2


@register_flop_formula([torch.ops.repro_torch.decode_attention, torch.ops.repro_torch.decode_attention_lse])
def _decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, h, d = q_shape
    return attention_flops(b, 1, k_shape[1], h, d, False)


@register_flop_formula(torch.ops.repro_torch.disagg_gram)
def _gram_flops(c_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    n, m = c_shape[-2:]
    return 2 * math.prod(c_shape[:-2]) * n * m * (m + 1)


def _kernel_path(name: str, x: torch.Tensor) -> bool:
    """True when ``x`` goes to the kernel's op: a CUDA tensor, real or fake,
    or a fake tensor on any device (its op call runs the fake
    implementation); False for a real CPU tensor (the plain version)."""
    if x.device.type == "cuda" or isinstance(x, FakeTensor):
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
        ctx.kernel = _kernel_path("flash_attention", q)
        if ctx.kernel:
            out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
        else:
            out, lse = ref.flash_fwd(q, k, v, causal, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.kernel:  # the backward's op wherever the forward took the op
            grads = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, dout, ctx.blocks[0])
        else:
            grads = ref.flash_bwd(q, k, v, out, lse, dout, *ctx.blocks)
        return (*grads, None, None, None)


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

    The CUDA kernels (forward and backward) choose their own tiles and
    ignore ``q_block`` and ``kv_block``; the plain versions (``flash_fwd``
    and ``flash_bwd``, CPU tensors only) block by them, as the reference
    does.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_block, kv_block)
    if _kernel_path("flash_attention", q):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal)
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
    if _kernel_path("decode_attention", q):
        return torch.ops.repro_torch.decode_attention(q, k_cache, v_cache, lengths.to(torch.int32))
    return ref.decode_attention(q, k_cache, v_cache, lengths)


def decode_attention_lse(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention`` and each row's log-sum-exp (B, H) fp32 (-inf
    for a sequence of length 0): what a cache split on its sequence axis
    merges its slices by (``models.attention.merge_partials``)."""
    if _kernel_path("decode_attention_lse", q):
        return torch.ops.repro_torch.decode_attention_lse(q, k_cache, v_cache, lengths.to(torch.int32))
    return ref.decode_attention(q, k_cache, v_cache, lengths, return_lse=True)


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched normal-equation assembly (C^T C, C^T W) for the fleet solve."""
    if _kernel_path("disagg_gram", c):
        return torch.ops.repro_torch.disagg_gram(c, w)
    return ref.disagg_gram(c, w)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm (the kernel's op) / plain version (CPU)."""
    if _kernel_path("rmsnorm", x):
        return torch.ops.repro_torch.rmsnorm(x, gamma, eps)
    return ref.rmsnorm(x, gamma, eps)
