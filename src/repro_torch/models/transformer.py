"""Decoder-only LM stacks: dense GQA, MoE and VLM -- the twin of the
decoder part of the reference's ``repro/models/transformer.py``.

Per-layer parameters live in ``params["layers"]`` (an ``nn.ModuleList``)
and the forward pass is a Python loop over them where the reference scans
over stacked leaves.  The MoE family replaces each block's MLP with
``moe.moe_apply`` (deepseek-moe's layer 0 is a dense block of its own,
``params["dense0"]``, with its own cache ``k0``/``v0``); the VLM family
prepends projected patch embeddings (``params["proj"]``) to the tokens.
With ``cfg.kv_cache_dtype == "int8"`` the scanned layers' cache is int8
with bf16 row scales (``k0``/``v0`` stay in the compute dtype, as in the
reference).  Entry points:

- ``decoder_train``   : tokens -> (logits over the full sequence, MoE aux),
  forward only (the consistency checks compare the serving path against it);
- ``decoder_prefill`` : tokens -> (last-position logits, decode cache);
- ``decoder_decode``  : one token + cache -> (logits, cache), the cache
  updated in place.

The hybrid stack waits for ROADMAP Queue 1 item 9.4.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.models.attention import attention_apply, attention_decode, attention_params
from repro_torch.models.common import Param, rms_norm, softcap, stack_params
from repro_torch.models.mlp import mlp_apply, mlp_params
from repro_torch.models.moe import moe_apply, moe_params

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
    """Token-embedding lookup in the compute dtype."""
    return params["embed"][tokens].to(compute_dtype(cfg))


def lm_logits(params, h: Tensor, cfg: ArchConfig) -> Tensor:
    """Final norm + (tied) unembedding + logit softcap."""
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["unembed"] if "unembed" in params else params["embed"].T
    return softcap(h @ w.to(h.dtype), cfg.logit_softcap)


def project_frontend(params, embeds: Tensor, cfg: ArchConfig) -> Tensor:
    """VLM stub frontend: norm + linear projector to d_model."""
    p = params["proj"]
    return rms_norm(embeds.to(compute_dtype(cfg)), p["ln"], cfg.norm_eps) @ p["w"]


def _embed_inputs(params, tokens: Tensor, cfg: ArchConfig, prefix_embeds: Tensor | None) -> Tensor:
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
    return h + m, aux


def _dense_block_prefill(p, h: Tensor, positions: Tensor, cfg: ArchConfig, *, moe: bool):
    """Like ``_dense_block`` but also returns the block's (k, v)."""
    a, (k, v) = attention_apply(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), positions, cfg, return_kv=True
    )
    h = h + a
    return h + _mixer(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg, moe)[0], (k, v)


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
    """Run the full decoder over hidden states.  Returns (h, aux_loss): the
    MoE aux summed over the scanned layers (0 for dense and VLM)."""
    moe = _is_moe(cfg)
    if "dense0" in params:
        h, _ = _dense_block(params["dense0"], h, positions, cfg, moe=False)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in params["layers"]:
        h, a = _dense_block(layer, h, positions, cfg, moe=moe)
        if a is not None:
            aux = aux + a
    return h, aux


def decoder_train(params, tokens: Tensor, cfg: ArchConfig, *, prefix_embeds: Tensor | None = None):
    """tokens (B, S) [with an optional (B, P, F) frontend prefix] ->
    (logits (B, P+S, V_padded), aux), forward only."""
    h = _embed_inputs(params, tokens, cfg, prefix_embeds)
    h, aux = decoder_hidden(params, h, _positions(h.shape[0], h.shape[1], h.device), cfg)
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
