"""Decode-cache allocation and residency accounting -- the twin of the
reference's ``repro/serving/kv_cache.py``.

A warm function's sandbox is a resident cache plus weights (the FaaS
keep-alive analogue); these give its bytes.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.sharding import place_tree
from repro_torch.models.common import tree_map
from repro_torch.models.model_zoo import ModelApi


def init_cache(api: ModelApi, shape: ShapeConfig, *, shardings: Any = None,
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Zero-filled decode cache matching ``cache_spec(shape)`` on ``device``;
    the sLSTM stabilizer state ``s_m`` starts at -1e30 (-inf-like).  Given
    ``shardings`` (a tree of ``NamedSharding``s matching the cache, e.g.
    ``sharding_for`` of each leaf's ``TensorSpec.axes``), each leaf is then
    placed by ``distributed.sharding.place_tree``: the rank's block on its
    mesh's device (a ``None`` sharding leaves its leaf on ``device``)."""
    dev = resolve_device(device)
    cache = tree_map(
        lambda name, s: torch.full(s.shape, -1e30 if name == "s_m" else 0, dtype=s.dtype, device=dev),
        api.cache_spec(shape),
    )
    return place_tree(cache, shardings)


def cache_bytes(api: ModelApi, shape: ShapeConfig) -> int:
    """Residency bytes of one warm cache (keep-alive memory accounting)."""
    sizes = []
    tree_map(
        lambda _, s: sizes.append(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()),
        api.cache_spec(shape),
    )
    return sum(sizes)


def params_bytes(api: ModelApi, dtype_bytes: int = 4) -> int:
    """Model parameter bytes at ``dtype_bytes`` per element."""
    sizes = []
    tree_map(lambda _, p: sizes.append(math.prod(p.shape) * dtype_bytes), api.params_def)
    return sum(sizes)
