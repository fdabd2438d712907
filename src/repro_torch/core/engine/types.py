"""Engine data contracts: configs, batch inputs, results.

The leaf module of the engine package: every other ``core.engine`` stage
imports its types from here and nothing here imports any of them back.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.kalman import KalmanConfig, KalmanState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide configuration, shared by every segment engine path.

    ``backend`` selects the gram assembly of ``run_fleet_gram``:
    ``"kernel"`` is the CUDA kernel (raises on a CPU tensor), ``"einsum"``
    the plain contraction, and ``"auto"`` the kernel for tensors on the card
    and the einsum elsewhere.
    """

    kalman: KalmanConfig = KalmanConfig()
    delta: float = 1.0          # tick (window) length in seconds
    backend: str = "auto"       # auto | einsum | kernel: gram-assembly backend
    init_iters: int = 400       # NNLS iterations for the whole-trace X_0
    init_ridge_lambda: float | None = None  # X_0 ridge; None -> kalman's

    @property
    def init_lam(self) -> float:
        """Ridge used for the initial X_0 solve (defaults to the Kalman's)."""
        return (
            self.kalman.ridge_lambda
            if self.init_ridge_lambda is None
            else self.init_ridge_lambda
        )


class FleetInputs(NamedTuple):
    """One fleet profiling batch: B nodes, S steps of n_w ticks, M functions.

    ``mask`` makes the fleet *ragged*: a (B, S, n_w) per-tick validity mask
    (1.0 = real tick, 0.0 = padding); ``None`` means every tick is real.
    Masked ticks contribute exactly zero energy and masked-out steps freeze
    the Kalman state.  ``fn_mask`` is a (B, M) per-node validity mask over a
    padded function axis; masked functions' output rows are exactly zero.
    """

    c: Tensor          # (B, S, n_w, M) contribution seconds per tick
    w: Tensor          # (B, S, n_w) idle-adjusted active power per tick (W)
    a: Tensor          # (B, S, M) invocation counts per step
    lat_sum: Tensor    # (B, S, M) summed latency per step
    lat_sumsq: Tensor  # (B, S, M) summed squared latency per step
    mask: Tensor | None = None     # (B, S, n_w) tick validity; None = all real
    fn_mask: Tensor | None = None  # (B, M) fn validity; None = all fns real

    def to(self, device: torch.device) -> "FleetInputs":
        """The same batch with every tensor on ``device``."""
        return FleetInputs(*(None if t is None else t.to(device) for t in self))


class FleetResult(NamedTuple):
    """Output of one fleet disaggregation (any engine path).

    ``tick_power``/``unattributed`` are None when computed with
    ``with_ticks=False``; otherwise ``tick_power.sum(-1) + unattributed``
    reproduces the measured per-tick power (efficiency per tick).
    """

    x_final: Tensor        # (B, M) final per-function power estimate (W)
    x_trajectory: Tensor   # (B, S, M) per-step estimates
    x0: Tensor             # (B, M) whole-trace initial estimate
    tick_power: Tensor | None    # (B, T, M) conserved per-tick power (W)
    unattributed: Tensor | None  # (B, T) power in ticks with no activity
    state: KalmanState     # batched final filter state
