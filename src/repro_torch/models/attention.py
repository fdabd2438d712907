"""Grouped-query attention: params, full-sequence apply, and decode.

The twin of the reference's ``repro/models/attention.py``.  Projections are
stored flattened -- wq: (d_model, H*head_dim) -- in the reference's layout.
The score/value contractions route through ``repro_torch.kernels.ops``
(the CUDA kernels on the card, the plain versions on the CPU); the
projections are plain ``torch.matmul``.  No mesh is active in the port, so
the reference's ``shard_activation`` calls (identities without one) are
dropped.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.common import Param, apply_rope


def attention_params(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """Parameter spec tree for one attention block (``cross`` adds enc-dec K/V)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": Param((d, qd), ("embed", "qkv")),
        "wk": Param((d, kvd), ("embed", "qkv")),
        "wv": Param((d, kvd), ("embed", "qkv")),
        "wo": Param((qd, d), ("o_in", "embed"), scale=1.0),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = Param((qd,), ("qkv",), init="zeros")
        p["bk"] = Param((kvd,), ("qkv",), init="zeros")
        p["bv"] = Param((kvd,), ("qkv",), init="zeros")
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig):
    """(B, S, d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd)."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(b, s, cfg.num_heads, cfg.head_dim),
        k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
        v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
    )


def attention_apply(
    p,
    x: torch.Tensor,           # (B, S, d)
    positions: torch.Tensor,   # (B, S)
    cfg: ArchConfig,
    *,
    return_kv: bool = False,
):
    """Full-sequence causal self-attention with rotary positions (prefill,
    and the full forward the consistency checks compare against).  The
    reference's ``causal=False``, ``use_rope=False`` and cross-attention
    ``memory`` options wait for the encoder-decoder family."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True)
    b, s = q.shape[:2]
    y = out.reshape(b, s, cfg.q_dim) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(
    p,
    x: torch.Tensor,          # (B, 1, d) current token activations
    pos: int,                 # write/attend position
    k_cache: torch.Tensor,    # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    cfg: ArchConfig,
    *,
    kv_scales=None,
):
    """Single-token decode step.  Returns (y (B,1,d), k_cache, v_cache),
    plus (k_scale, v_scale) when the cache is int8 (``kv_scales`` given:
    (B, S_max, Hkv) row scales).

    The reference returns updated copies of the (donated) caches; here the
    new K/V row (and its scales) is written in place at ``pos`` and the
    same tensors are returned.  The int8 branch quantizes the new row and
    attends through ``ref.decode_attention_quant``, which the reference
    calls directly on every device (it has no Pallas kernel).  The
    cross-attention ``memory_kv`` branch waits for the encoder-decoder
    family.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        for cache, scales, row in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
            row_q, row_s = ref.quantize_kv(row[:, 0])
            cache[:, pos] = row_q
            scales[:, pos] = row_s.to(scales.dtype)
        out = ref.decode_attention_quant(q[:, 0], k_cache, v_cache, k_scale, v_scale, lengths)
        y = out.reshape(b, cfg.q_dim) @ p["wo"]
        return y[:, None, :], k_cache, v_cache, (k_scale, v_scale)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)
    y = out.reshape(b, cfg.q_dim) @ p["wo"]
    return y[:, None, :], k_cache, v_cache
