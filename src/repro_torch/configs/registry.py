"""Architecture registry: ``--arch <id>`` lookup for launchers and tests."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig, is_skipped, shapes_for

_MODULES = {
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, *, reduced: bool = False) -> ArchConfig:
    """Architecture config by name (``reduced`` selects the small variant)."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(_MODULES[name])
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(*, reduced: bool = False) -> dict[str, ArchConfig]:
    """Every registered architecture config, keyed by name."""
    return {n: get_config(n, reduced=reduced) for n in ARCH_NAMES}


def all_cells() -> list[tuple[str, str, bool]]:
    """All 40 assigned (arch, shape, skipped) cells."""
    cells = []
    for name in ARCH_NAMES:
        fam = get_config(name).family
        for sname in SHAPES:
            cells.append((name, sname, is_skipped(fam, sname)))
    return cells


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells not skipped on this container."""
    return [(a, s) for a, s, skip in all_cells() if not skip]


def get_shape(name: str) -> ShapeConfig:
    """Shape config by name."""
    return SHAPES[name]


__all__ = [
    "ARCH_NAMES",
    "get_config",
    "all_configs",
    "all_cells",
    "runnable_cells",
    "get_shape",
    "shapes_for",
    "is_skipped",
]
