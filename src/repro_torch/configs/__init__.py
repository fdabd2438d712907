"""Architecture configs (one module per arch) + shape registry: plain copies
of the reference's ``repro.configs`` data, imported from here so the port
needs nothing of the JAX package."""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import (
    ARCH_NAMES,
    all_cells,
    all_configs,
    get_config,
    get_shape,
    is_skipped,
    runnable_cells,
    shapes_for,
)
from repro_torch.configs.shapes import SHAPES, ShapeConfig

__all__ = [
    "ArchConfig",
    "ARCH_NAMES",
    "all_cells",
    "all_configs",
    "get_config",
    "get_shape",
    "is_skipped",
    "runnable_cells",
    "shapes_for",
    "SHAPES",
    "ShapeConfig",
]
