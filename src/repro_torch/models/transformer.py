"""Decoder-only LM stacks: dense GQA, MoE, VLM and the Zamba2 hybrid -- the
twin of the reference's ``repro/models/transformer.py``.

Per-layer parameters live in ``params["layers"]`` (an ``nn.ModuleList``)
and the forward pass is a Python loop over them where the reference scans
over stacked leaves.  The MoE family replaces each block's MLP with
``moe.moe_apply`` (deepseek-moe's layer 0 is a dense block of its own,
``params["dense0"]``, with its own cache ``k0``/``v0``); the VLM family
prepends projected patch embeddings (``params["proj"]``) to the tokens.
With ``cfg.kv_cache_dtype == "int8"`` the scanned layers' cache is int8
with bf16 row scales (``k0``/``v0`` stay in the compute dtype, as in the
reference).  Entry points:

- ``decoder_hidden_states`` / ``decoder_train`` : tokens -> final hidden
  states / logits over the full sequence, and the MoE aux: the training
  forward (each block under the config's ``remat`` policy,
  ``common.maybe_remat``), and what the consistency checks compare the
  serving path against;
- ``decoder_prefill`` : tokens -> (last-position logits, decode cache);
- ``decoder_decode``  : one token + cache -> (logits, cache), the cache
  updated in place.

The hybrid stack (zamba2) is a Mamba2 backbone (``params["layers"]``, each
``{"ln", "mamba"}``) with ONE weight-shared attention + SwiGLU block
(``params["shared"]``) applied before layers 0, k, 2k, ... (k =
``attn_every``); its cache holds one KV pair per application point
(``attn_k``/``attn_v``, indexed ``idx // k``), each layer's SSM state
``ssm_h`` (fp32) and conv tail ``conv``.  ``hybrid_train`` (remat'd per
layer, shared block included, as the reference's scan body),
``hybrid_prefill`` and ``hybrid_decode`` mirror the three entry points
above.  On this rank's "model" blocks (``sharding.local_view(split=...)``)
the Mamba2 layers run on the rank's heads (``models/ssm.py``), the shared
block on its attention heads and MLP columns, and the cache holds the
rank's blocks: its kv heads (or rows), and each layer's SSM state on its
heads and conv tail on its channels.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard_activation
from repro_torch.kernels import ref
from repro_torch.models.attention import attention_apply, attention_decode, attention_params
from repro_torch.models.common import Param, embed_rows, maybe_remat, rms_norm, softcap, stack_params, vocab_logits
from repro_torch.models.mlp import mlp_apply, mlp_params
from repro_torch.models.moe import moe_apply, moe_params
from repro_torch.models.ssm import mamba_apply, mamba_decode, mamba_params
from repro_torch.spans import span

Tensor = torch.Tensor


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.compute_dtype``."""
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _block_params(cfg: ArchConfig, *, moe: bool) -> dict:
    return {
        "ln1": Param((cfg.d_model,), (None,), init="ones"),
        "ln2": Param((cfg.d_model,), (None,), init="ones"),
        "attn": attention_params(cfg),
        "mixer": moe_params(cfg) if moe else mlp_params(cfg),
    }


def _is_moe(cfg: ArchConfig) -> bool:
    return cfg.family == "moe"


def scanned_layers(cfg: ArchConfig) -> int:
    """Layers in ``params["layers"]``: all but deepseek's dense layer 0."""
    return cfg.num_layers - (1 if _is_moe(cfg) and cfg.first_dense else 0)


def hybrid_params(cfg: ArchConfig) -> dict:
    """Zamba2: stacked Mamba2 backbone + ONE weight-shared attention block."""
    d, v = cfg.d_model, cfg.padded_vocab
    backbone = {"ln": Param((d,), (None,), init="ones"), "mamba": mamba_params(cfg)}
    return {
        "embed": Param((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "ln_f": Param((d,), (None,), init="ones"),
        "unembed": Param((d, v), ("embed", "lm_head"), fan_in=d),
        "layers": stack_params(backbone, cfg.num_layers),
        "shared": _block_params(cfg, moe=False),  # the shared attention block
    }


def decoder_params(cfg: ArchConfig) -> dict:
    """Stacked parameter spec tree for the dense / moe / vlm decoders."""
    d, v = cfg.d_model, cfg.padded_vocab
    moe = _is_moe(cfg)
    params = {
        "embed": Param((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "ln_f": Param((d,), (None,), init="ones"),
        "layers": stack_params(_block_params(cfg, moe=moe), scanned_layers(cfg)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = Param((d, v), ("embed", "lm_head"), fan_in=d)
    if moe and cfg.first_dense:
        params["dense0"] = _block_params(cfg, moe=False)
    if cfg.family == "vlm":
        # Frontend projector: precomputed ViT patch embeddings -> d_model.
        params["proj"] = {
            "w": Param((cfg.frontend_dim, d), ("frontend", "embed")),
            "ln": Param((cfg.frontend_dim,), (None,), init="ones"),
        }
    return params


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    """Token-embedding lookup in the compute dtype, activation-sharded; a
    vocab-parallel lookup on this rank's block of the table
    (``common.embed_rows``)."""
    table = embed_rows(params["embed"], tokens, cfg.padded_vocab)
    return shard_activation(table.to(compute_dtype(cfg)), ("batch", "seq", "act_embed"))


def lm_logits(params, h: Tensor, cfg: ArchConfig) -> Tensor:
    """Final norm + (tied) unembedding + logit softcap.  On this rank's
    vocabulary block of the unembedding (or of the tied table), the logits
    are its block too (``common.vocab_logits``).  Span ``model.unembed``."""
    with span("model.unembed"):
        h = rms_norm(h, params["ln_f"], cfg.norm_eps)
        w = params["unembed"] if "unembed" in params else params["embed"].T
        logits = vocab_logits(h, w.to(h.dtype), cfg.padded_vocab)
        return shard_activation(softcap(logits, cfg.logit_softcap), ("batch", "seq", "vocab"))


def project_frontend(params, embeds: Tensor, cfg: ArchConfig) -> Tensor:
    """VLM stub frontend: norm + linear projector to d_model."""
    p = params["proj"]
    return rms_norm(embeds.to(compute_dtype(cfg)), p["ln"], cfg.norm_eps) @ p["w"]


def _embed_inputs(params, tokens: Tensor, cfg: ArchConfig, prefix_embeds: Tensor | None) -> Tensor:
    with span("model.embed"):
        h = embed_tokens(params, tokens, cfg)
        if prefix_embeds is not None:
            h = torch.cat([project_frontend(params, prefix_embeds, cfg), h], dim=1)
        return h


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _mixer(p, x: Tensor, cfg: ArchConfig, moe: bool):
    """The block's channel mixer: (out, MoE aux or None)."""
    if moe:
        return moe_apply(p, x, cfg)
    return mlp_apply(p, x, cfg), None


def _dense_block(p, h: Tensor, positions: Tensor, cfg: ArchConfig, *, moe: bool):
    """Pre-norm attention + channel mixer.  Returns (h, aux or None)."""
    h = h + attention_apply(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), positions, cfg)
    m, aux = _mixer(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg, moe)
    return shard_activation(h + m, ("batch", "seq", "act_embed")), aux


def _dense_block_prefill(p, h: Tensor, positions: Tensor, cfg: ArchConfig, *, moe: bool):
    """Like ``_dense_block`` but also returns the block's (k, v)."""
    a, (k, v) = attention_apply(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), positions, cfg, return_kv=True
    )
    h = h + a
    h = h + _mixer(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg, moe)[0]
    return shard_activation(h, ("batch", "seq", "act_embed")), (k, v)


def _dense_block_decode(p, h: Tensor, pos: int, k_c: Tensor, v_c: Tensor, cfg: ArchConfig,
                        *, moe: bool, scales: tuple | None = None) -> Tensor:
    """One block's decode step; the cache rows (and scales) at ``pos`` are
    written in place."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + attention_decode(p["attn"], x, pos, k_c, v_c, cfg, kv_scales=scales)[0]
    return h + _mixer(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg, moe)[0]


# ---------------------------------------------------------------------------
# Dense / MoE / VLM decoder stack
# ---------------------------------------------------------------------------


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device).expand(b, s)


def decoder_hidden(params, h: Tensor, positions: Tensor, cfg: ArchConfig):
    """Run the full decoder over hidden states, each block under
    ``cfg.remat``.  Returns (h, aux_loss): the MoE aux summed over the
    scanned layers (0 for dense and VLM)."""
    moe = _is_moe(cfg)
    if "dense0" in params:
        block0 = maybe_remat(lambda p, x: _dense_block(p, x, positions, cfg, moe=False), cfg.remat)
        h, _ = block0(params["dense0"], h)
    block = maybe_remat(lambda p, x: _dense_block(p, x, positions, cfg, moe=moe), cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in params["layers"]:
        h, a = block(layer, h)
        if a is not None:
            aux = aux + a
    return h, aux


def decoder_hidden_states(params, tokens: Tensor, cfg: ArchConfig, *, prefix_embeds: Tensor | None = None):
    """tokens (B, S) [with an optional (B, P, F) frontend prefix] -> (final
    hidden states (B, P+S, d) before ``ln_f``, aux)."""
    h = _embed_inputs(params, tokens, cfg, prefix_embeds)
    return decoder_hidden(params, h, _positions(h.shape[0], h.shape[1], h.device), cfg)


def decoder_train(params, tokens: Tensor, cfg: ArchConfig, *, prefix_embeds: Tensor | None = None):
    """tokens (B, S) [with an optional (B, P, F) frontend prefix] ->
    (logits (B, P+S, V_padded), aux)."""
    h, aux = decoder_hidden_states(params, tokens, cfg, prefix_embeds=prefix_embeds)
    return lm_logits(params, h, cfg), aux


def decoder_prefill(params, tokens: Tensor, cfg: ArchConfig, *, prefix_embeds: Tensor | None = None):
    """Prefill: returns (last-position logits (B, 1, V), cache dict).

    The cache holds "k" and "v" (L, B, S, Hkv, hd) in the compute dtype, or
    int8 with "k_scale"/"v_scale" (L, B, S, Hkv) in bf16 for an int8 cache;
    plus "k0"/"v0" (B, S, Hkv, hd) for a dense layer 0.  S counts the
    prefix's patches."""
    h = _embed_inputs(params, tokens, cfg, prefix_embeds)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    moe = _is_moe(cfg)
    cache = {}
    if "dense0" in params:
        h, (cache["k0"], cache["v0"]) = _dense_block_prefill(params["dense0"], h, positions, cfg, moe=False)
    ks, vs = [], []
    for layer in params["layers"]:
        h, (k, v) = _dense_block_prefill(layer, h, positions, cfg, moe=moe)
        ks.append(k)
        vs.append(v)
    with span("model.cache"):
        if cfg.kv_cache_dtype == "int8":
            (cache["k"], cache["k_scale"]), (cache["v"], cache["v_scale"]) = (
                ref.quantize_kv(torch.stack(ks)), ref.quantize_kv(torch.stack(vs)))
        else:
            cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
    return lm_logits(params, h[:, -1:], cfg), cache


def decoder_decode(params, cache: dict, token: Tensor, pos: int, cfg: ArchConfig):
    """One decode step.  token (B, 1), pos the write index shared by the
    batch.  The cache buffers are (L, B, S_max, ...); each layer's new row
    is written in place (the reference donates the cache and returns an
    updated copy)."""
    h = embed_tokens(params, token, cfg)
    moe = _is_moe(cfg)
    if "k0" in cache:
        h = _dense_block_decode(params["dense0"], h, pos, cache["k0"], cache["v0"], cfg, moe=False)
    int8 = cfg.kv_cache_dtype == "int8"
    for i, layer in enumerate(params["layers"]):
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if int8 else None
        h = _dense_block_decode(layer, h, pos, cache["k"][i], cache["v"][i], cfg, moe=moe, scales=scales)
    return lm_logits(params, h, cfg), cache


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack
# ---------------------------------------------------------------------------


def _attn_every(cfg: ArchConfig) -> int:
    return max(cfg.attn_every, 1)


def n_attn_points(cfg: ArchConfig) -> int:
    """Shared-attention application points (layers 0, k, 2k, ...): 14 of
    zamba2-7b's 81 layers at k = 6."""
    k = _attn_every(cfg)
    return (cfg.num_layers + k - 1) // k


def hybrid_train(params, tokens: Tensor, cfg: ArchConfig):
    """tokens (B, S) -> (logits (B, S, V_padded), aux 0); each layer (with
    the shared block before it at an application point) under
    ``cfg.remat``."""
    h = embed_tokens(params, tokens, cfg)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    k = _attn_every(cfg)

    def layer_fn(layer, shared, x, with_attn):
        if with_attn:
            x, _ = _dense_block(shared, x, positions, cfg, moe=False)
        x = x + mamba_apply(layer["mamba"], rms_norm(x, layer["ln"], cfg.norm_eps), cfg)
        return shard_activation(x, ("batch", "seq", "act_embed"))

    block = maybe_remat(layer_fn, cfg.remat)
    for idx, layer in enumerate(params["layers"]):
        h = block(layer, params["shared"], h, idx % k == 0)
    return lm_logits(params, h, cfg), torch.zeros((), dtype=torch.float32, device=h.device)


def hybrid_prefill(params, tokens: Tensor, cfg: ArchConfig):
    """Prefill: returns (last-position logits (B, 1, V), cache).

    The cache holds "attn_k"/"attn_v" (napp, B, S, Hkv, hd), one KV pair per
    application point of the shared block, "ssm_h" (L, B, H, P, N) fp32 and
    "conv" (L, B, K-1, d_inner)."""
    h = embed_tokens(params, tokens, cfg)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    k = _attn_every(cfg)
    ks, vs, states, tails = [], [], [], []
    for idx, layer in enumerate(params["layers"]):
        if idx % k == 0:
            h, (ak, av) = _dense_block_prefill(params["shared"], h, positions, cfg, moe=False)
            ks.append(ak)
            vs.append(av)
        y, (ssm_h, tail) = mamba_apply(
            layer["mamba"], rms_norm(h, layer["ln"], cfg.norm_eps), cfg, return_state=True)
        h = h + y
        states.append(ssm_h)
        tails.append(tail)
    cache = {"attn_k": shard_activation(torch.stack(ks), (None, "batch", "kv_seq", "kv_heads", None)),
             "attn_v": torch.stack(vs), "ssm_h": torch.stack(states),
             "conv": torch.stack(tails)}
    return lm_logits(params, h[:, -1:], cfg), cache


def hybrid_decode(params, cache: dict, token: Tensor, pos: int, cfg: ArchConfig):
    """One decode step of the hybrid stack.  The application point's KV row
    at ``pos`` and every layer's SSM state and conv tail are updated in
    place."""
    h = embed_tokens(params, token, cfg)
    k = _attn_every(cfg)
    for idx, layer in enumerate(params["layers"]):
        if idx % k == 0:
            point = idx // k
            h = _dense_block_decode(params["shared"], h, pos, cache["attn_k"][point], cache["attn_v"][point], cfg,
                                    moe=False)
        x = rms_norm(h, layer["ln"], cfg.norm_eps)
        h = h + mamba_decode(layer["mamba"], x, cache["ssm_h"][idx], cache["conv"][idx], cfg)[0]
    return lm_logits(params, h, cfg), cache
