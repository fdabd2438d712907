"""Public entry points for the compute hot-spots, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
launch — there is no fallback on the card); a CPU tensor goes to the plain
version in ``ref.py``.  The reference's ``REPRO_FORCE_KERNELS`` override has
no twin: nothing can send a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import disagg_solve as ds
from repro_torch.kernels import ref


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched normal-equation assembly (C^T C, C^T W) for the fleet solve."""
    if c.device.type == "cuda":
        return ds.disagg_gram(c, w)
    if c.device.type == "cpu":
        return ref.disagg_gram(c, w)
    raise ValueError(f"disagg_gram has no path for device {c.device}")
