"""Decoder-only LM stack, dense GQA family -- the twin of the dense part of
the reference's ``repro/models/transformer.py``.

Per-layer parameters live in ``params["layers"]`` (an ``nn.ModuleList``)
and the forward pass is a Python loop over them where the reference scans
over stacked leaves.  Entry points:

- ``decoder_train``   : tokens -> logits over the full sequence (forward
  only; the consistency checks compare the serving path against it);
- ``decoder_prefill`` : tokens -> (last-position logits, decode cache);
- ``decoder_decode``  : one token + cache -> (logits, cache), the cache
  updated in place.

The MoE, VLM and hybrid stacks wait for their slices (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (
    INT8_CACHE,
    attention_apply,
    attention_decode,
    attention_params,
)
from repro_torch.models.common import Param, rms_norm, softcap, stack_params
from repro_torch.models.mlp import mlp_apply, mlp_params

Tensor = torch.Tensor


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port's decoder stack has the dense family only; "
            f"family {cfg.family!r} waits for ROADMAP Queue 1 item 9"
        )


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.compute_dtype``."""
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _block_params(cfg: ArchConfig) -> dict:
    return {
        "ln1": Param((cfg.d_model,), (None,), init="ones"),
        "ln2": Param((cfg.d_model,), (None,), init="ones"),
        "attn": attention_params(cfg),
        "mixer": mlp_params(cfg),
    }


def decoder_params(cfg: ArchConfig) -> dict:
    """Stacked parameter spec tree for the dense decoder."""
    _dense_only(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params = {
        "embed": Param((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "ln_f": Param((d,), (None,), init="ones"),
        "layers": stack_params(_block_params(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = Param((d, v), ("embed", "lm_head"), fan_in=d)
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


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _dense_block(p, h: Tensor, positions: Tensor, cfg: ArchConfig) -> Tensor:
    """Pre-norm attention + SwiGLU / sq_relu mixer."""
    h = h + attention_apply(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), positions, cfg)
    return h + mlp_apply(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)


def _dense_block_prefill(p, h: Tensor, positions: Tensor, cfg: ArchConfig):
    """Like ``_dense_block`` but also returns the block's (k, v)."""
    a, (k, v) = attention_apply(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), positions, cfg, return_kv=True
    )
    h = h + a
    h = h + mlp_apply(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg)
    return h, (k, v)


def _dense_block_decode(p, h: Tensor, pos: int, k_c: Tensor, v_c: Tensor, cfg: ArchConfig):
    a, k_c, v_c = attention_decode(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), pos, k_c, v_c, cfg)
    h = h + a
    return h + mlp_apply(p["mixer"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg), k_c, v_c


# ---------------------------------------------------------------------------
# Dense decoder stack
# ---------------------------------------------------------------------------


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device).expand(b, s)


def decoder_hidden(params, h: Tensor, positions: Tensor, cfg: ArchConfig):
    """Run the full decoder over hidden states.  Returns (h, aux_loss = 0)."""
    _dense_only(cfg)
    for layer in params["layers"]:
        h = _dense_block(layer, h, positions, cfg)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def decoder_train(params, tokens: Tensor, cfg: ArchConfig):
    """tokens (B, S) -> (logits (B, S, V_padded), aux = 0), forward only."""
    h = embed_tokens(params, tokens, cfg)
    h, aux = decoder_hidden(params, h, _positions(*tokens.shape, tokens.device), cfg)
    return lm_logits(params, h, cfg), aux


def decoder_prefill(params, tokens: Tensor, cfg: ArchConfig):
    """Prefill: returns (last-position logits (B, 1, V), cache dict with
    "k" and "v" of shape (L, B, S, Hkv, hd) in the compute dtype)."""
    _dense_only(cfg)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(INT8_CACHE)
    h = embed_tokens(params, tokens, cfg)
    positions = _positions(*tokens.shape, tokens.device)
    ks, vs = [], []
    for layer in params["layers"]:
        h, (k, v) = _dense_block_prefill(layer, h, positions, cfg)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return lm_logits(params, h[:, -1:], cfg), cache


def decoder_decode(params, cache: dict, token: Tensor, pos: int, cfg: ArchConfig):
    """One decode step.  token (B, 1), pos the write index shared by the
    batch.  The cache KV buffers are (L, B, S_max, Hkv, hd); each layer's
    new row is written in place (the reference donates the cache and
    returns an updated copy)."""
    _dense_only(cfg)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(INT8_CACHE)
    h = embed_tokens(params, token, cfg)
    for i, layer in enumerate(params["layers"]):
        h, _, _ = _dense_block_decode(layer, h, pos, cache["k"][i], cache["v"][i], cfg)
    return lm_logits(params, h, cfg), cache
