"""Unified model API -- the twin of the reference's ``repro/models/model_zoo.py``
for the families the port has: dense, moe and vlm (one decoder stack, with
the int8 KV cache as an option of each) and ssm (xLSTM).

``build(cfg)`` returns a :class:`ModelApi`:

- ``params_def``                        declarative Param tree
- ``prefill(params, batch)``            -> (last logits, decode cache)
- ``decode(params, cache, token, pos)`` -> (logits, cache)   [serve step]
- ``prefill_inputs/decode_inputs(shape)`` TensorSpec trees
- ``cache_spec(shape)``                 TensorSpec tree matching the cache

``loss`` and ``train_inputs`` wait for the training slice (ROADMAP Queue 1
item 9.7); the hybrid and encoder-decoder families for items 9.4 and 9.6.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_mod


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    axes: tuple[str | None, ...]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    params_def: Any
    prefill: Callable          # (params, batch) -> (logits, cache)
    decode: Callable           # (params, cache, token, pos) -> (logits, cache)
    prefill_inputs: Callable   # (ShapeConfig) -> TensorSpec tree
    decode_inputs: Callable    # (ShapeConfig) -> token/pos specs
    cache_spec: Callable       # (ShapeConfig) -> TensorSpec tree


def _tok(b: int, s: int) -> TensorSpec:
    return TensorSpec((b, s), torch.int32, ("batch", None))


def _decode_inputs(shape: ShapeConfig) -> dict:
    return {"token": _tok(shape.global_batch, 1), "pos": TensorSpec((), torch.int32, ())}


def _build_decoder(cfg: ArchConfig) -> ModelApi:
    """dense / moe / vlm.  A VLM prompt of ``seq_len`` is ``frontend_tokens``
    patch embeddings followed by ``seq_len - frontend_tokens`` tokens."""
    vlm = cfg.family == "vlm"
    n_scan = tf.scanned_layers(cfg)
    cdt = tf.compute_dtype(cfg)

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

    return ModelApi(cfg, tf.decoder_params(cfg), prefill, decode, prefill_inputs, _decode_inputs, cache_spec)


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

    return ModelApi(cfg, xlstm_mod.xlstm_params(cfg), prefill, decode, prefill_inputs, _decode_inputs, cache_spec)


_BUILDERS = {"dense": _build_decoder, "moe": _build_decoder, "vlm": _build_decoder, "ssm": _build_xlstm}

#: Where each family the port lacks is queued.
_QUEUED = {
    "hybrid": "ROADMAP Queue 1 item 9.4 (hybrid: zamba2's Mamba2 block and stack)",
    "encdec": "ROADMAP Queue 1 item 9.6 (encdec: seamless)",
}


def build(cfg: ArchConfig) -> ModelApi:
    """Construct the ``ModelApi`` for a config's model family."""
    if cfg.family in _BUILDERS:
        return _BUILDERS[cfg.family](cfg)
    if cfg.family in _QUEUED:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet: {_QUEUED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")


#: cache entries that grow along their KV-sequence axis (axis index), per
#: family, as the reference's.  Recurrent states never grow.
_GROWABLE = {
    "dense": {"k": 2, "v": 2, "k0": 1, "v0": 1, "k_scale": 2, "v_scale": 2},
    "moe": {"k": 2, "v": 2, "k0": 1, "v0": 1, "k_scale": 2, "v_scale": 2},
    "vlm": {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2},
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
    its patch embeddings -- the first decode step's write index."""
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
