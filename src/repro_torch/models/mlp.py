"""Channel mixers: SwiGLU (llama-family) and squared-ReLU (nemotron-4).

The twin of the reference's ``repro/models/mlp.py``.  The three products
are plain ``torch.matmul``, as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Param


def mlp_params(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    """Parameter spec tree for the configured MLP variant (swiglu / sq_relu)."""
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            "w_gate": Param((d, f), ("embed", "mlp")),
            "w_up": Param((d, f), ("embed", "mlp")),
            "w_down": Param((f, d), ("mlp", "embed")),
        }
    if cfg.mlp == "sq_relu":
        return {
            "w_up": Param((d, f), ("embed", "mlp")),
            "w_down": Param((f, d), ("mlp", "embed")),
        }
    raise ValueError(f"unknown mlp kind {cfg.mlp!r}")


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Apply the MLP block matching the ``mlp_params`` layout; x (B, S, d)."""
    if "w_gate" in p:
        h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        r = torch.relu(x @ p["w_up"])
        h = r * r  # squared ReLU (nemotron-4)
    return h @ p["w_down"]
