"""Unified model API -- the twin of the reference's ``repro/models/model_zoo.py``
over all its families: dense, moe and vlm (one decoder stack, with the int8
KV cache as an option of each), hybrid (zamba2), ssm (xLSTM) and encdec
(seamless).

``build(cfg)`` returns a :class:`ModelApi`:

- ``params_def``                        declarative Param tree
- ``loss(params, batch)``               -> (loss, metrics): the full train
  forward + masked CE (+ the MoE aux loss, weighted ``MOE_AUX_WEIGHT``)
- ``prefill(params, batch)``            -> (last logits, decode cache)
- ``decode(params, cache, token, pos)`` -> (logits, cache)   [serve step]
- ``train_inputs/prefill_inputs/decode_inputs(shape)`` TensorSpec trees
- ``cache_spec(shape)``                 TensorSpec tree matching the cache

``loss`` reads ``params`` as the other entry points do: a ``ParamTree`` in
the compute dtype, or the training path's ``common.ComputeView`` of fp32
masters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import chunked_lm_loss, cross_entropy_loss, rms_norm

MOE_AUX_WEIGHT = 0.01

#: Source length of an encoder-decoder's cross-attention memory in the
#: cache spec of a decode cell (a ~30 s utterance), as the reference's.
DECODE_SRC_LEN = 4096


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    axes: tuple[str | None, ...]
    sharding: Any = None  # a NamedSharding, set by distributed.sharding.abstract_with_sharding


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    params_def: Any
    loss: Callable             # (params, batch) -> (loss, metrics)
    prefill: Callable          # (params, batch) -> (logits, cache)
    decode: Callable           # (params, cache, token, pos) -> (logits, cache)
    train_inputs: Callable     # (ShapeConfig) -> TensorSpec tree
    prefill_inputs: Callable   # (ShapeConfig) -> TensorSpec tree
    decode_inputs: Callable    # (ShapeConfig) -> token/pos specs
    cache_spec: Callable       # (ShapeConfig) -> TensorSpec tree


def _tok(b: int, s: int) -> TensorSpec:
    return TensorSpec((b, s), torch.int32, ("batch", None))


def _decode_inputs(shape: ShapeConfig) -> dict:
    return {"token": _tok(shape.global_batch, 1), "pos": TensorSpec((), torch.int32, ())}


def _with_labels(prefill_inputs: Callable) -> Callable:
    """train_inputs: the prefill inputs plus labels shaped like the tokens."""
    def train_inputs(shape: ShapeConfig) -> dict:
        spec = prefill_inputs(shape)
        return {**spec, "labels": spec["tokens"]}
    return train_inputs


def _lm_loss(forward: Callable, cfg: ArchConfig) -> Callable:
    """loss for a family whose ``forward(params, batch)`` gives (logits, aux)."""
    def loss(params, batch):
        logits, _ = forward(params, batch)
        return cross_entropy_loss(logits, batch["labels"], cfg.vocab_size, padded_vocab=cfg.padded_vocab)
    return loss


def _build_decoder(cfg: ArchConfig) -> ModelApi:
    """dense / moe / vlm.  A VLM prompt of ``seq_len`` is ``frontend_tokens``
    patch embeddings followed by ``seq_len - frontend_tokens`` tokens."""
    vlm = cfg.family == "vlm"
    n_scan = tf.scanned_layers(cfg)
    cdt = tf.compute_dtype(cfg)

    def loss(params, batch):
        prefix = batch.get("patches") if vlm else None
        labels = batch["labels"]
        if vlm:  # no label at the patch positions
            labels = torch.cat([labels.new_full((labels.shape[0], cfg.frontend_tokens), -1), labels], dim=1)
        if cfg.ce_chunk > 0:
            h, aux = tf.decoder_hidden_states(params, batch["tokens"], cfg, prefix_embeds=prefix)
            h = rms_norm(h, params["ln_f"], cfg.norm_eps)
            w = params["unembed"] if "unembed" in params else params["embed"].T
            l, metrics = chunked_lm_loss(h, w, labels, cfg.vocab_size, cfg.ce_chunk, logit_softcap=cfg.logit_softcap,
                                         padded_vocab=cfg.padded_vocab)
        else:
            logits, aux = tf.decoder_train(params, batch["tokens"], cfg, prefix_embeds=prefix)
            l, metrics = cross_entropy_loss(logits, labels, cfg.vocab_size, padded_vocab=cfg.padded_vocab)
        if cfg.family == "moe":
            l = l + MOE_AUX_WEIGHT * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = l
        return l, metrics

    def prefill(params, batch):
        return tf.decoder_prefill(params, batch["tokens"], cfg, prefix_embeds=batch.get("patches") if vlm else None)

    def decode(params, cache, token, pos):
        return tf.decoder_decode(params, cache, token, pos, cfg)

    def prefill_inputs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if vlm:
            p = cfg.frontend_tokens
            return {
                "patches": TensorSpec((b, p, cfg.frontend_dim), cdt, ("batch", None, None)),
                "tokens": _tok(b, s - p),
            }
        return {"tokens": _tok(b, s)}

    def cache_spec(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        kv = (n_scan, b, s, cfg.num_kv_heads, cfg.head_dim)
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        if cfg.kv_cache_dtype == "int8":
            q = TensorSpec(kv, torch.int8, kv_axes)
            sc = TensorSpec(kv[:-1], torch.bfloat16, kv_axes[:-1])
            spec = {"k": q, "v": q, "k_scale": sc, "v_scale": sc}
        else:
            spec = {"k": TensorSpec(kv, cdt, kv_axes), "v": TensorSpec(kv, cdt, kv_axes)}
        if cfg.family == "moe" and cfg.first_dense:
            spec["k0"] = spec["v0"] = TensorSpec(kv[1:], cdt, kv_axes[1:])
        return spec

    return ModelApi(cfg, tf.decoder_params(cfg), loss, prefill, decode, _with_labels(prefill_inputs), prefill_inputs,
                    _decode_inputs, cache_spec)


def _build_xlstm(cfg: ArchConfig) -> ModelApi:
    def prefill(params, batch):
        return xlstm_mod.xlstm_prefill(params, batch["tokens"], cfg)

    def decode(params, cache, token, pos):
        return xlstm_mod.xlstm_decode(params, cache, token, pos, cfg)

    def prefill_inputs(shape: ShapeConfig):
        return {"tokens": _tok(shape.global_batch, shape.seq_len)}

    def cache_spec(shape: ShapeConfig):
        b, pairs, h = shape.global_batch, cfg.num_layers // 2, cfg.num_heads
        p_m = 2 * cfg.d_model // h     # mLSTM head dim
        p_s = cfg.d_model // h         # sLSTM head dim
        s_state = TensorSpec((pairs, b, h, p_s), torch.float32, ("layers", "batch", "heads", None))
        spec = {"m": TensorSpec((pairs, b, h, p_m + 1, p_m), torch.float32, ("layers", "batch", "heads", None, None))}
        spec.update({name: s_state for name in xlstm_mod.S_KEYS})
        return spec

    loss = _lm_loss(lambda params, batch: xlstm_mod.xlstm_train(params, batch["tokens"], cfg), cfg)
    return ModelApi(cfg, xlstm_mod.xlstm_params(cfg), loss, prefill, decode, _with_labels(prefill_inputs),
                    prefill_inputs, _decode_inputs, cache_spec)


def _build_hybrid(cfg: ArchConfig) -> ModelApi:
    napp = tf.n_attn_points(cfg)
    cdt = tf.compute_dtype(cfg)

    def prefill(params, batch):
        return tf.hybrid_prefill(params, batch["tokens"], cfg)

    def decode(params, cache, token, pos):
        return tf.hybrid_decode(params, cache, token, pos, cfg)

    def prefill_inputs(shape: ShapeConfig):
        return {"tokens": _tok(shape.global_batch, shape.seq_len)}

    def cache_spec(shape: ShapeConfig):
        b, s, layers = shape.global_batch, shape.seq_len, cfg.num_layers
        kv = TensorSpec((napp, b, s, cfg.num_kv_heads, cfg.head_dim), cdt, (None, "batch", "kv_seq", "kv_heads", None))
        return {
            "attn_k": kv,
            "attn_v": kv,
            "ssm_h": TensorSpec((layers, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32,
                                ("layers", "batch", "heads", None, None)),
            "conv": TensorSpec((layers, b, cfg.ssm_conv - 1, cfg.d_inner), cdt, ("layers", "batch", None, "mlp")),
        }

    loss = _lm_loss(lambda params, batch: tf.hybrid_train(params, batch["tokens"], cfg), cfg)
    return ModelApi(cfg, tf.hybrid_params(cfg), loss, prefill, decode, _with_labels(prefill_inputs), prefill_inputs,
                    _decode_inputs, cache_spec)


def _build_encdec(cfg: ArchConfig) -> ModelApi:
    """seamless: the source is ``seq_len`` frame embeddings, as many as the
    target prompt's tokens (the reference's ``prefill_inputs``)."""
    cdt = tf.compute_dtype(cfg)

    def prefill(params, batch):
        return encdec_mod.encdec_prefill(params, batch["src_embeds"], batch["tokens"], cfg)

    def decode(params, cache, token, pos):
        return encdec_mod.encdec_decode(params, cache, token, pos, cfg)

    def prefill_inputs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        return {
            "src_embeds": TensorSpec((b, s, cfg.frontend_dim), cdt, ("batch", None, None)),
            "tokens": _tok(b, s),
        }

    def cache_spec(shape: ShapeConfig):
        b, s, layers = shape.global_batch, shape.seq_len, cfg.num_layers
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        kv = TensorSpec((layers, b, s, cfg.num_kv_heads, cfg.head_dim), cdt, axes)
        cross = TensorSpec((layers, b, min(s, DECODE_SRC_LEN), cfg.num_kv_heads, cfg.head_dim), cdt, axes)
        return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}

    loss = _lm_loss(lambda params, batch: encdec_mod.encdec_train(params, batch["src_embeds"], batch["tokens"], cfg),
                    cfg)
    return ModelApi(cfg, encdec_mod.encdec_params(cfg), loss, prefill, decode, _with_labels(prefill_inputs),
                    prefill_inputs, _decode_inputs, cache_spec)


_BUILDERS = {
    "dense": _build_decoder,
    "moe": _build_decoder,
    "vlm": _build_decoder,
    "hybrid": _build_hybrid,
    "ssm": _build_xlstm,
    "encdec": _build_encdec,
}


def build(cfg: ArchConfig) -> ModelApi:
    """Construct the ``ModelApi`` for a config's model family."""
    if cfg.family not in _BUILDERS:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")
    return _BUILDERS[cfg.family](cfg)


#: cache entries that grow along their KV-sequence axis (axis index), per
#: family, as the reference's.  Cross-attention KV and recurrent states
#: never grow.
_GROWABLE = {
    "dense": {"k": 2, "v": 2, "k0": 1, "v0": 1, "k_scale": 2, "v_scale": 2},
    "moe": {"k": 2, "v": 2, "k0": 1, "v0": 1, "k_scale": 2, "v_scale": 2},
    "vlm": {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2},
    "hybrid": {"attn_k": 2, "attn_v": 2},
    "encdec": {"k": 2, "v": 2},
    "ssm": {},
}


def extend_cache(api: ModelApi, cache: dict, extra: int) -> dict:
    """Grow the decode cache by ``extra`` KV slots (zeros; masked by pos).

    A prefill over S tokens returns caches with exactly S slots; decoding N
    further tokens needs S+N.  Zero padding is safe: decode attention
    attends to rows below ``lengths = pos + 1`` only, so unwritten slots
    are never read.
    """
    if extra <= 0:
        return cache
    out = dict(cache)
    for name, axis in _GROWABLE[api.cfg.family].items():
        if name not in out:
            continue
        x = out[name]
        shape = list(x.shape)
        shape[axis] = extra
        out[name] = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return out


def prompt_length(batch: dict) -> int:
    """Positions a prefill of ``batch`` fills: its tokens plus, for a VLM,
    its patch embeddings -- the first decode step's write index.  An
    encoder-decoder's source frames are the encoder's, not decode
    positions."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline's usefulness ratio: train 6*N*D,
    prefill 2*N*D, decode 2*N per sequence; MoE counts its active
    parameters.  D = tokens processed by the step."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
