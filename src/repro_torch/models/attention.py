"""Grouped-query attention: params, full-sequence apply, and decode.

The twin of the reference's ``repro/models/attention.py``.  Projections are
stored flattened -- wq: (d_model, H*head_dim) -- in the reference's layout.
The score/value contractions route through ``repro_torch.kernels.ops``
(the CUDA kernels on the card, the plain versions on the CPU); the
projections are plain ``torch.matmul``.  The reference's four
``shard_activation`` calls (q and k after the rotary embedding, the decode
cache after its write) are made at the same places; they are identities on
plain tensors and outside a rule context.

**Split over "model"** (``distributed.tensor_parallel``).  Given this
rank's "model" blocks of the weights (``sharding.local_view(split=...)``),
``wq``/``wk``/``wv`` and their biases are column-parallel and ``wo``
row-parallel, ending in a reduce over "model"; attention runs on the
rank's heads.  The rules' divisibility fallbacks give three cases, with M
the "model" size:

- H and Hkv divide by M: each rank holds its q heads and their kv heads;
- H divides, Hkv does not (its flat width does): K and V are gathered from
  "model" to all kv heads (the rules' fallback to replicated "kv_heads")
  and the rank keeps the kv heads its q heads read, in GQA order (q head
  ``h`` reads kv head ``h // (H / Hkv)``); their gradient is summed over
  "model", since the ranks read different heads of the same K and V;
- H does not divide (its flat width does): q, K and V are gathered to all
  heads, attention runs on all of them, and the output is scattered back
  to the rank's flat columns before the row-parallel ``wo`` (GSPMD's
  behaviour when "heads" falls back to replication).

A split prefill keeps its cache where the serve rules put it: the rank's kv
heads in the first case, else the rank's block of the sequence ("kv_seq").
A split decode reads it there: on the kv_seq block the rank gathers q's
heads, attends over its own rows with the decode kernel's log-sum-exp store
(``ops.decode_attention_lse``), and the (out, lse) pairs of the ranks are
merged (``merge_partials``); only the owner of row ``pos`` writes it.  An
int8 cache splits the same ways, its row scales with its rows, and attends
through the plain ``ref.decode_attention_quant`` (its lse on kv_seq).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_activation
from repro_torch.kernels import ops, ref
from repro_torch.models.common import Param, apply_rope
from repro_torch.spans import span


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
    """(B, S, d), (B, T, d) -> q (B,S,H,hd), k/v (B,T,Hkv,hd), and the
    split: (axis, q gathered) -- ``axis`` None on whole weights; with it, q
    holds the rank's heads, or all heads when they do not divide (``q
    gathered``), and k/v the rank's kv heads, or all of them when theirs do
    not divide."""
    b, s, _ = x.shape
    t = kv_x.shape[1]
    q_axis = tp.split_of(p["wq"].shape[1], cfg.q_dim)
    kv_axis = tp.split_of(p["wk"].shape[1], cfg.kv_dim)
    xq = x if q_axis is None else tp.copy_to_model(x, q_axis)
    if kv_axis is None:
        xkv = kv_x
    else:
        xkv = xq if kv_x is x and q_axis is not None else tp.copy_to_model(kv_x, kv_axis)
    q, k, v = xq @ p["wq"], xkv @ p["wk"], xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if kv_axis is not None and cfg.num_kv_heads % kv_axis.size:
        k, v = tp.gather_from_model(k, kv_axis, -1), tp.gather_from_model(v, kv_axis, -1)
    q_whole = q_axis is not None and cfg.num_heads % q_axis.size != 0
    if q_whole:
        q = tp.gather_from_model(q, q_axis, -1)
    return (
        q.reshape(b, s, -1, cfg.head_dim),
        k.reshape(b, t, -1, cfg.head_dim),
        v.reshape(b, t, -1, cfg.head_dim),
    ), (q_axis or kv_axis, q_whole)


def _rank_kv_heads(cfg: ArchConfig, axis: tp.ModelAxis) -> slice:
    """The kv heads the rank's H / M q heads read, in GQA order: a whole
    number of groups of them (H / M a multiple of H / Hkv), or one kv head
    that they share (H / Hkv a multiple of H / M)."""
    hl, g = cfg.num_heads // axis.size, cfg.num_heads // cfg.num_kv_heads
    if hl % g and g % hl:
        raise ValueError(f"{hl} q heads a rank do not form GQA groups of {g}")
    first = axis.rank * hl // g
    return slice(first, first + max(hl // g, 1))


def _attended(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, split):
    """The K and V the rank's q heads attend: when q holds the rank's heads
    and K/V all kv heads, the kv heads those q heads read, with their
    gradient summed over "model"."""
    axis, q_whole = split
    if axis is None or q_whole or k.shape[2] < cfg.num_kv_heads or q.shape[2] == cfg.num_heads:
        return k, v
    heads = _rank_kv_heads(cfg, axis)
    k, v = tp.copy_to_model(k, axis), tp.copy_to_model(v, axis)
    return k[:, :, heads], v[:, :, heads]


def _out_proj(p, out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """out (..., width) @ wo: row-parallel on this rank's block of ``wo``
    -- its flat columns of all heads' output, or its own heads' output --
    then summed over "model"."""
    axis = tp.split_of(p["wo"].shape[0], cfg.q_dim)
    if axis is None:
        return out @ p["wo"]
    if out.shape[-1] == cfg.q_dim:
        out = tp.scatter_to_model(out, axis, -1)
    return tp.reduce_from_model(out @ p["wo"], axis)


def _cache_rows(x: torch.Tensor, cfg: ArchConfig, axis) -> torch.Tensor:
    """The K or V (B, T, Hkv, hd) a split prefill keeps: the rank's kv heads
    as they are, else its block of T ("kv_seq")."""
    if axis is None or x.shape[2] < cfg.num_kv_heads:
        return x
    if x.shape[1] % axis.size:
        raise ValueError(f"a split cache keeps its rows on 'model': {x.shape[1]} rows do not divide by {axis.size}")
    return tp.scatter_to_model(x, axis, 1)


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
    the static memory K/V a decoder's cache keeps.  On this rank's "model"
    blocks of the weights, the split program (module docstring).  Span
    ``model.attention``."""
    with span("model.attention"):
        (q, k, v), split = _project_qkv(p, x, x if memory is None else memory, cfg)
        if use_rope and memory is None:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        q = shard_activation(q, ("batch", "seq", "heads", None))
        k = shard_activation(k, ("batch", "seq", "kv_heads", None))
        kv = (k, v)
        out = ops.flash_attention(q, *_attended(q, k, v, cfg, split), causal=causal)
        b, s = q.shape[:2]
        y = _out_proj(p, out.reshape(b, s, -1), cfg)
        if return_kv:
            return y, tuple(_cache_rows(t, cfg, split[0]) for t in kv)
        return y


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over the union of disjoint key sets from each set's
    (out, log-sum-exp): outs (M, B, H, d), lses (M, B, H) fp32 -> (B, H, d)
    in outs' dtype, in fp32.  A set with no live key (lse -inf) gets weight
    0 whatever its output; a sequence with none at all gives 0."""
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)
    den = w.sum(dim=0).clamp(min=1e-30)
    out = (w[..., None] * outs.to(torch.float32)).sum(dim=0) / den[..., None]
    return out.to(outs.dtype)


def _decode_rows(q, k_cache, v_cache, lengths, axis, scales=None):
    """Attention of q (B, H, d) over the "model" ranks' blocks of a cache
    split on kv_seq: each rank attends its own rows (``lengths`` global,
    clipped to the block), and the ranks' (out, lse) are merged.  An int8
    block (its row ``scales`` given) attends through the plain
    ``ref.decode_attention_quant``."""
    rows = k_cache.shape[1]
    local = torch.clamp(lengths - axis.rank * rows, 0, rows).to(torch.int32)
    if scales is None:
        out, lse = ops.decode_attention_lse(q, k_cache, v_cache, local)
    else:
        out, lse = ref.decode_attention_quant(q, k_cache, v_cache, *scales, local, return_lse=True)
    outs = tp.gather_from_model(out[None], axis, 0)
    lses = tp.gather_from_model(lse[None], axis, 0)
    return merge_partials(outs, lses)


def _split_decode(p, x, pos, k_cache, v_cache, cfg, memory_kv, axis, kv_scales=None, use_rope=True):
    """``attention_decode`` on this rank's "model" blocks of the weights and
    of the cache (module docstring); an int8 cache's row scales are split
    as its rows are."""
    b, hd = x.shape[0], cfg.head_dim
    cache_k = k_cache if memory_kv is None else memory_kv[0]
    on_rows = cache_k.shape[2] == cfg.num_kv_heads  # the cache split on kv_seq, not on kv_heads
    q = x[:, 0] @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q_axis = tp.split_of(p["wq"].shape[1], cfg.q_dim)
    if on_rows and q_axis is not None:
        q = tp.gather_from_model(q, q_axis, -1)
    q = q.reshape(b, -1, hd)
    if memory_kv is not None:
        k_mem, v_mem = memory_kv
        if on_rows:
            lengths = torch.full((b,), k_mem.shape[1] * axis.size, dtype=torch.int32, device=x.device)
            out = _decode_rows(q, k_mem, v_mem, lengths, axis)
        else:
            lengths = torch.full((b,), k_mem.shape[1], dtype=torch.int32, device=x.device)
            out = ops.decode_attention(q, k_mem, v_mem, lengths)
        return _out_proj(p, out.reshape(b, -1), cfg)[:, None, :], k_cache, v_cache
    k, v = x[:, 0] @ p["wk"], x[:, 0] @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    kv_axis = tp.split_of(p["wk"].shape[1], cfg.kv_dim)
    if on_rows and kv_axis is not None:
        k, v = tp.gather_from_model(k, kv_axis, -1), tp.gather_from_model(v, kv_axis, -1)
    k = k.reshape(b, -1, hd)
    if use_rope:
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q[:, None], positions, cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], positions, cfg.rope_theta)[:, 0]
    v = v.reshape(b, -1, hd)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    row = pos - axis.rank * k_cache.shape[1] if on_rows else pos
    if 0 <= row < k_cache.shape[1]:  # this rank holds row ``pos``
        if kv_scales is None:
            k_cache[:, row] = k.to(k_cache.dtype)
            v_cache[:, row] = v.to(v_cache.dtype)
        else:
            for cache, scales, new in ((k_cache, kv_scales[0], k), (v_cache, kv_scales[1], v)):
                cache[:, row], row_s = ref.quantize_kv(new)
                scales[:, row] = row_s.to(scales.dtype)
    if on_rows:
        out = _decode_rows(q, k_cache, v_cache, lengths, axis, kv_scales)
    elif kv_scales is None:
        out = ops.decode_attention(q, k_cache, v_cache, lengths)
    else:
        out = ref.decode_attention_quant(q, k_cache, v_cache, *kv_scales, lengths)
    y = _out_proj(p, out.reshape(b, -1), cfg)[:, None, :]
    return (y, k_cache, v_cache) if kv_scales is None else (y, k_cache, v_cache, kv_scales)


def attention_decode(
    p,
    x: torch.Tensor,          # (B, 1, d) current token activations
    pos: int,                 # write/attend position
    k_cache: torch.Tensor,    # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    cfg: ArchConfig,
    *,
    memory_kv: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attention (k_mem, v_mem)
    use_rope: bool = True,
    kv_scales=None,
):
    """Single-token decode step.  Returns (y (B,1,d), k_cache, v_cache),
    plus (k_scale, v_scale) when the cache is int8 (``kv_scales`` given:
    (B, S_max, Hkv) row scales).  ``use_rope=False`` leaves q and the new
    K row without rotary positions, as ``attention_apply`` does.

    The reference returns updated copies of the (donated) caches; here the
    new K/V row (and its scales) is written in place at ``pos`` and the
    same tensors are returned.  The int8 branch quantizes the new row and
    attends through ``ref.decode_attention_quant``, which the reference
    calls directly on every device (it has no Pallas kernel).  With
    ``memory_kv`` (B, T, Hkv, hd) the step is cross-attention to a static
    encoder memory: no cache write, no rotary positions, the decode kernel
    at ``lengths = T`` for every sequence; the caches come back untouched.
    On this rank's "model" blocks of the weights and the cache, the split
    step (module docstring), the int8 cache's through the plain
    ``ref.decode_attention_quant`` on the rank's kv heads, or on its rows
    with that function's log-sum-exp merged.
    """
    axis = tp.split_of(p["wq"].shape[1], cfg.q_dim) or tp.split_of(p["wk"].shape[1], cfg.kv_dim)
    if axis is not None:
        return _split_decode(p, x, pos, k_cache, v_cache, cfg, memory_kv, axis, kv_scales, use_rope)
    b = x.shape[0]
    if memory_kv is not None:
        k_mem, v_mem = memory_kv
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        lengths = torch.full((b,), k_mem.shape[1], dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q.reshape(b, cfg.num_heads, cfg.head_dim), k_mem, v_mem, lengths)
        return (out.reshape(b, cfg.q_dim) @ p["wo"])[:, None, :], k_cache, v_cache
    (q, k, v), _ = _project_qkv(p, x, x, cfg)
    if use_rope:
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
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
