"""Grouped-query attention: params, full-sequence apply, and decode.

The twin of the reference's ``repro/models/attention.py``.  Projections are
stored flattened -- wq: (d_model, H*head_dim) -- in the reference's layout.
The score/value contractions route through ``repro_torch.kernels.ops``
(the CUDA kernels on the card, the plain versions on the CPU); the
projections are plain ``torch.matmul``.  The reference's four
``shard_activation`` calls (q and k after the rotary embedding, the decode
cache after its write) are made at the same places; they are identities on
plain tensors and outside a rule context.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard_activation
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


def _project_qkv(p, x: torch.Tensor, kv_x: torch.Tensor, cfg: ArchConfig):
    """(B, S, d), (B, T, d) -> q (B,S,H,hd), k/v (B,T,Hkv,hd)."""
    b, s, _ = x.shape
    t = kv_x.shape[1]
    q, k, v = x @ p["wq"], kv_x @ p["wk"], kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(b, s, cfg.num_heads, cfg.head_dim),
        k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim),
        v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim),
    )


def attention_apply(
    p,
    x: torch.Tensor,           # (B, S, d)
    positions: torch.Tensor,   # (B, S)
    cfg: ArchConfig,
    *,
    causal: bool = True,
    memory: torch.Tensor | None = None,   # (B, T, d) cross-attention source
    use_rope: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention: causal self-attention with rotary positions
    (prefill, and the full forward the consistency checks compare against),
    the encoder's non-causal self-attention (``causal=False``), and
    cross-attention to an encoder ``memory`` (no rotary positions, S != T).
    With ``return_kv``, also the (k, v) it attended to: for cross-attention
    the static memory K/V a decoder's cache keeps."""
    q, k, v = _project_qkv(p, x, x if memory is None else memory, cfg)
    if use_rope and memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_activation(q, ("batch", "seq", "heads", None))
    k = shard_activation(k, ("batch", "seq", "kv_heads", None))
    out = ops.flash_attention(q, k, v, causal=causal)
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
    memory_kv: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attention (k_mem, v_mem)
    kv_scales=None,
):
    """Single-token decode step.  Returns (y (B,1,d), k_cache, v_cache),
    plus (k_scale, v_scale) when the cache is int8 (``kv_scales`` given:
    (B, S_max, Hkv) row scales).

    The reference returns updated copies of the (donated) caches; here the
    new K/V row (and its scales) is written in place at ``pos`` and the
    same tensors are returned.  The int8 branch quantizes the new row and
    attends through ``ref.decode_attention_quant``, which the reference
    calls directly on every device (it has no Pallas kernel).  With
    ``memory_kv`` (B, T, Hkv, hd) the step is cross-attention to a static
    encoder memory: no cache write, no rotary positions, the decode kernel
    at ``lengths = T`` for every sequence; the caches come back untouched.
    """
    b = x.shape[0]
    if memory_kv is not None:
        k_mem, v_mem = memory_kv
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        lengths = torch.full((b,), k_mem.shape[1], dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q.reshape(b, cfg.num_heads, cfg.head_dim), k_mem, v_mem, lengths)
        return (out.reshape(b, cfg.q_dim) @ p["wo"])[:, None, :], k_cache, v_cache
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg)
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
    k_cache = shard_activation(k_cache, ("batch", "kv_seq", "kv_heads", None))
    v_cache = shard_activation(v_cache, ("batch", "kv_seq", "kv_heads", None))
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths)
    y = out.reshape(b, cfg.q_dim) @ p["wo"]
    return y[:, None, :], k_cache, v_cache
