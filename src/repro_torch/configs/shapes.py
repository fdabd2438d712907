"""Assigned input shapes (LM-family: seq_len x global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``; ``prefill_*`` lowers the prefill
step.  ``long_500k`` requires sub-quadratic attention: it runs only for the
SSM/hybrid architectures (zamba2-7b, xlstm-350m) and is a *noted skip* for
the eight pure full-attention archs (see DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

#: Families with a sub-quadratic token mixer, eligible for long_500k.
SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def shapes_for(family: str) -> list[ShapeConfig]:
    """The assigned shape set for an architecture family (with noted skips)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if family in SUBQUADRATIC_FAMILIES:
        out.append(LONG_500K)
    return out


def is_skipped(family: str, shape_name: str) -> bool:
    """True when the (family, shape) cell is excluded (quadratic families at 500k)."""
    return shape_name == "long_500k" and family not in SUBQUADRATIC_FAMILIES
