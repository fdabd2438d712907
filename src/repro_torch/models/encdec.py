"""Encoder-decoder stack (seamless-m4t-large-v2's backbone) -- the twin of
the reference's ``repro/models/encdec.py``.

The speech frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings (B, S_src, frontend_dim), which the encoder
takes through an RMSNorm and a learned projection, then non-causal
self-attention blocks.  Decoder layers carry causal self-attention,
cross-attention to the encoder memory (no rotary positions, S != T) and a
SwiGLU MLP.  The per-layer subtrees are ``params["enc_layers"]`` and
``params["dec_layers"]``, Python loops where the reference scans.

Decode cache: per-layer self-attention K/V ("k"/"v", written in place at
``pos``) and per-layer cross-attention K/V ("cross_k"/"cross_v"), computed
once from the memory at prefill and static afterwards.  Cross decode runs
the decode kernel with ``lengths = S_src`` for every sequence.

The reference's five ``shard_activation`` calls are made at its places:
three here (the encoder's projection and each encoder and decoder block's
output), and the target embedding's and the logits' through the
transformer's ``embed_tokens`` and ``lm_logits``, which make them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.attention import attention_apply, attention_decode, attention_params
from repro_torch.models.common import Param, maybe_remat, rms_norm, stack_params
from repro_torch.models.mlp import mlp_apply, mlp_params
from repro_torch.models.transformer import _positions, compute_dtype, embed_tokens, lm_logits

Tensor = torch.Tensor


def _enc_block_params(cfg: ArchConfig) -> dict:
    return {
        "ln1": Param((cfg.d_model,), (None,), init="ones"),
        "ln2": Param((cfg.d_model,), (None,), init="ones"),
        "attn": attention_params(cfg),
        "mlp": mlp_params(cfg),
    }


def _dec_block_params(cfg: ArchConfig) -> dict:
    return {
        "ln1": Param((cfg.d_model,), (None,), init="ones"),
        "ln_x": Param((cfg.d_model,), (None,), init="ones"),
        "ln2": Param((cfg.d_model,), (None,), init="ones"),
        "attn": attention_params(cfg),
        "cross": attention_params(cfg, cross=True),
        "mlp": mlp_params(cfg),
    }


def encdec_params(cfg: ArchConfig) -> dict:
    """Parameter spec tree for the encoder-decoder family."""
    d, v, f = cfg.d_model, cfg.padded_vocab, cfg.frontend_dim
    return {
        "proj": {
            "w": Param((f, d), ("frontend", "embed")),
            "ln": Param((f,), (None,), init="ones"),
        },
        "enc_layers": stack_params(_enc_block_params(cfg), cfg.encoder_layers),
        "enc_ln_f": Param((d,), (None,), init="ones"),
        "embed": Param((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "dec_layers": stack_params(_dec_block_params(cfg), cfg.num_layers),
        "ln_f": Param((d,), (None,), init="ones"),
        "unembed": Param((d, v), ("embed", "lm_head"), fan_in=d),
    }


def encode(params, src_embeds: Tensor, cfg: ArchConfig) -> Tensor:
    """(B, S_src, F) frame embeddings -> (B, S_src, d) memory; each layer
    under ``cfg.remat``."""
    p = params["proj"]
    h = rms_norm(src_embeds.to(compute_dtype(cfg)), p["ln"], cfg.norm_eps) @ p["w"]
    h = shard_activation(h, ("batch", "seq", "act_embed"))
    positions = _positions(h.shape[0], h.shape[1], h.device)

    def layer_fn(layer, x):
        x = x + attention_apply(layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), positions, cfg, causal=False)
        x = x + mlp_apply(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps), cfg)
        return shard_activation(x, ("batch", "seq", "act_embed"))

    block = maybe_remat(layer_fn, cfg.remat)
    for layer in params["enc_layers"]:
        h = block(layer, h)
    return rms_norm(h, params["enc_ln_f"], cfg.norm_eps)


def _dec_block(layer, x: Tensor, positions: Tensor, memory: Tensor, cfg: ArchConfig):
    """One decoder block over the full target sequence.  Returns (x, (k, v),
    (cross k, cross v)): the block's self-attention K/V and the static
    cross-attention K/V of ``memory``."""
    a, kv = attention_apply(layer["attn"], rms_norm(x, layer["ln1"], cfg.norm_eps), positions, cfg, return_kv=True)
    x = x + a
    c, cross_kv = attention_apply(
        layer["cross"], rms_norm(x, layer["ln_x"], cfg.norm_eps), positions, cfg,
        causal=False, memory=memory, use_rope=False, return_kv=True,
    )
    x = x + c
    x = x + mlp_apply(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps), cfg)
    return shard_activation(x, ("batch", "seq", "act_embed")), kv, cross_kv


def encdec_train(params, src_embeds: Tensor, tgt_tokens: Tensor, cfg: ArchConfig):
    """Teacher-forced full-sequence decode over the encoded source: (logits
    (B, S, V_padded), aux 0); each decoder layer under ``cfg.remat``."""
    memory = encode(params, src_embeds, cfg)
    h = embed_tokens(params, tgt_tokens, cfg)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    block = maybe_remat(lambda layer, x: _dec_block(layer, x, positions, memory, cfg)[0], cfg.remat)
    for layer in params["dec_layers"]:
        h = block(layer, h)
    return lm_logits(params, h, cfg), torch.zeros((), dtype=torch.float32, device=h.device)


def encdec_prefill(params, src_embeds: Tensor, tgt_tokens: Tensor, cfg: ArchConfig):
    """Encode, then a teacher-forced prefill of the target prefix.  Returns
    (last-position logits (B, 1, V), cache): "k"/"v" (L, B, S, Hkv, hd) and
    the static "cross_k"/"cross_v" (L, B, S_src, Hkv, hd)."""
    memory = encode(params, src_embeds, cfg)
    h = embed_tokens(params, tgt_tokens, cfg)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    per_layer = []
    for layer in params["dec_layers"]:
        h, kv, cross_kv = _dec_block(layer, h, positions, memory, cfg)
        per_layer.append(kv + cross_kv)
    cache = {name: torch.stack([entry[i] for entry in per_layer])
             for i, name in enumerate(("k", "v", "cross_k", "cross_v"))}
    return lm_logits(params, h[:, -1:], cfg), cache


def encdec_decode(params, cache: dict, token: Tensor, pos: int, cfg: ArchConfig):
    """One decoder step with the self-attention cache (row ``pos`` written
    in place) and the static cross-attention cache."""
    h = embed_tokens(params, token, cfg)
    for i, layer in enumerate(params["dec_layers"]):
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = h + attention_decode(layer["attn"], rms_norm(h, layer["ln1"], cfg.norm_eps), pos, k_c, v_c, cfg)[0]
        h = h + attention_decode(layer["cross"], rms_norm(h, layer["ln_x"], cfg.norm_eps), pos, k_c, v_c, cfg,
                                 memory_kv=(cache["cross_k"][i], cache["cross_v"][i]))[0]
        h = h + mlp_apply(layer["mlp"], rms_norm(h, layer["ln2"], cfg.norm_eps), cfg)
    return lm_logits(params, h, cfg), cache
