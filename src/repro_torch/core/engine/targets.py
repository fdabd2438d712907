"""Target stage: what signal the engines disaggregate (pure vs §4.3 combined).

The engines are target-agnostic: combined mode (§4.3) feeds them the
chip-subtracted 'rest' power instead of the idle-adjusted system signal.
Every profiling path — per-node, batched segment and streaming — builds its
combined targets through these two helpers, so the mode cannot drift
between paths.  (The chip side is attributed by ``core.cpu_model``'s
fleet-batched counter model; this module is only the target arithmetic.)
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def fleet_rest_idle(chip_init: Tensor, idle_watts) -> Tensor:
    """Idle power of the non-chip components, per node (§4.3).

    Approximated as total idle minus the chip's observed floor over the
    N_init initial-estimate block: ``max(idle - min(chip_init), 0)``.  The
    init block (not the full segment) keeps the estimate identical across
    the per-node, batched and *streaming* paths — the stream knows only the
    init windows when it must start producing combined targets.

    Args:
      chip_init: (..., N_init) chip power over the init block (one node or
        a (B, N_init) fleet).
      idle_watts: scalar or (...,) per-node total idle power.

    Returns:
      (...,) rest-side idle watts, on ``chip_init``'s device (no host read).
    """
    idle = torch.as_tensor(idle_watts, dtype=torch.float32, device=chip_init.device)
    return torch.clamp(idle - torch.amin(chip_init, dim=-1), min=0.0)


def combined_rest_target(w_sys: Tensor, chip: Tensor, rest_idle) -> Tensor:
    """Combined-mode (§4.3) disaggregation target: the 'rest' power,
    ``max(W_sys - W_chip - rest_idle, 0)``.

    The chip side is modeled by the linear counter model, so the
    Kalman/NNLS engines disaggregate only what is left of the system
    signal.  Pure broadcasting: callers align ``rest_idle`` themselves
    (scalar, ``(B, 1)`` against ``(B, N)`` windows, or ``(B,)`` against a
    tick's ``(B,)`` power).  A chipless row (chip identically 0,
    ``rest_idle`` = idle) gives exactly the pure target.
    """
    return torch.clamp(w_sys - chip - rest_idle, min=0.0)
