"""Channel mixers: SwiGLU (llama-family) and squared-ReLU (nemotron-4).

The twin of the reference's ``repro/models/mlp.py``.  The three products
are plain ``torch.matmul``, as the reference leaves them to XLA.  Given
this rank's "model" blocks of the weights (``sharding.local_view(split=
...)``), ``w_gate`` and ``w_up`` are column-parallel and ``w_down``
row-parallel, ending in a reduce over "model"
(``distributed.tensor_parallel``), as GSPMD splits them for the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
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


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig, d_ff: int | None = None) -> torch.Tensor:
    """Apply the MLP block matching the ``mlp_params(cfg, d_ff)`` layout;
    x (B, S, d).  Weights narrower than ``d_ff`` are this rank's "model"
    blocks: the hidden width is split and the output summed over "model"."""
    axis = tp.split_of(p["w_down"].shape[0], d_ff if d_ff is not None else cfg.d_ff)
    if axis is not None:
        x = tp.copy_to_model(x, axis)
    if "w_gate" in p:
        h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        r = torch.relu(x @ p["w_up"])
        h = r * r  # squared ReLU (nemotron-4)
    y = h @ p["w_down"]
    return y if axis is None else tp.reduce_from_model(y, axis)
