"""Unified model API -- the twin of the reference's ``repro/models/model_zoo.py``
for the families the port has (dense).

``build(cfg)`` returns a :class:`ModelApi`:

- ``params_def``                        declarative Param tree
- ``prefill(params, batch)``            -> (last logits, decode cache)
- ``decode(params, cache, token, pos)`` -> (logits, cache)   [serve step]
- ``prefill_inputs/decode_inputs(shape)`` TensorSpec trees
- ``cache_spec(shape)``                 TensorSpec tree matching the cache

``loss`` and ``train_inputs`` wait for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.attention import INT8_CACHE


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


def _build_decoder(cfg: ArchConfig) -> ModelApi:
    """The dense decoder."""

    def prefill(params, batch):
        return tf.decoder_prefill(params, batch["tokens"], cfg)

    def decode(params, cache, token, pos):
        return tf.decoder_decode(params, cache, token, pos, cfg)

    def prefill_inputs(shape: ShapeConfig):
        return {"tokens": _tok(shape.global_batch, shape.seq_len)}

    def decode_inputs(shape: ShapeConfig):
        return {"token": _tok(shape.global_batch, 1), "pos": TensorSpec((), torch.int32, ())}

    def cache_spec(shape: ShapeConfig):
        if cfg.kv_cache_dtype == "int8":
            raise NotImplementedError(INT8_CACHE)
        kv = TensorSpec(
            (cfg.num_layers, shape.global_batch, shape.seq_len, cfg.num_kv_heads, cfg.head_dim),
            tf.compute_dtype(cfg),
            ("layers", "batch", "kv_seq", "kv_heads", None),
        )
        return {"k": kv, "v": kv}

    return ModelApi(cfg, tf.decoder_params(cfg), prefill, decode, prefill_inputs, decode_inputs, cache_spec)


_BUILDERS = {"dense": _build_decoder}

#: Where each family the port lacks is queued.
_QUEUED = {
    "moe": "ROADMAP Queue 1 item 9 (MoE: olmoe, deepseek-moe)",
    "vlm": "ROADMAP Queue 1 item 9 (VLM)",
    "hybrid": "ROADMAP Queue 1 item 9 (hybrid: zamba2)",
    "ssm": "ROADMAP Queue 1 item 9 (xLSTM)",
    "encdec": "ROADMAP Queue 1 item 9 (encdec)",
}


def build(cfg: ArchConfig) -> ModelApi:
    """Construct the ``ModelApi`` for a config's model family."""
    if cfg.family in _BUILDERS:
        return _BUILDERS[cfg.family](cfg)
    if cfg.family in _QUEUED:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet: {_QUEUED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")


#: cache entries that grow along their KV-sequence axis (axis index), per family.
_GROWABLE = {"dense": {"k": 2, "v": 2}}


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
