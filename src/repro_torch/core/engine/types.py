"""Engine data contracts: configs, batch inputs, stream state, results.

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


class FleetStep(NamedTuple):
    """Inputs for ONE telemetry tick (delta window) across the fleet.

    Shapes: B nodes x M functions, on the stream state's device.
    ``a``/``lat_sum``/``lat_sumsq`` carry the invocations *starting* in this
    tick; the engine only reads their running sums at Kalman-step
    boundaries, so any within-step placement that sums to the per-step
    statistics is equivalent (``fleet_ticks`` puts each step's totals on its
    first valid tick).

    ``valid`` makes the tick *ragged*: a (B,) per-node liveness flag (1.0 =
    this node really produced this tick).  Invalid node-ticks are folded to
    zero telemetry before they touch the ring buffer or the attribution
    split; ``None`` means every node is live.
    """

    c: Tensor          # (B, M) contribution seconds within this tick
    w: Tensor          # (B,)   idle-adjusted active power this tick (W)
    a: Tensor          # (B, M) invocations starting in this tick
    lat_sum: Tensor    # (B, M) summed latency of those invocations (s)
    lat_sumsq: Tensor  # (B, M) summed squared latency (s^2)
    valid: Tensor | None = None  # (B,) node liveness this tick; None = all live

    def at(self, t: int) -> "FleetStep":
        """Tick ``t`` of a time-major (T, B, ...) stream (``fleet_ticks``)."""
        return FleetStep(*(None if x is None else x[t] for x in self))


class FleetStreamState(NamedTuple):
    """Carried state of the streaming engine.

    The batched Kalman state, a ring buffer of the current partial step's
    ticks and the running invocation/latency sums are tensors that
    ``fleet_step`` updates in place: they keep their storage for the whole
    stream.  The two counters are host ints, because the step boundary is a
    function of the tick index alone, so the dispatching thread never reads
    the device to know it.

    Invariants: ``tick_in_step`` in [0, n_w); rows [0, tick_in_step) of
    ``c_buf``/``w_buf`` hold the current partial step (later rows are stale
    and fully overwritten before the next boundary reads them);
    ``a``/``lat_sum``/``lat_sumsq`` accumulate the partial step and are
    zeroed at each boundary; ``step_idx`` counts completed Kalman steps.
    """

    kalman: KalmanState  # batched filter state, leading node axis B
    c_buf: Tensor        # (B, n_w, M) contribution rows of the partial step
    w_buf: Tensor        # (B, n_w)    power ticks of the partial step
    a: Tensor            # (B, M)      invocations so far in the partial step
    lat_sum: Tensor      # (B, M)
    lat_sumsq: Tensor    # (B, M)
    tick_in_step: int    # ticks in the partial step
    step_idx: int        # completed Kalman steps


class TickAttribution(NamedTuple):
    """Live per-tick output of the streaming engine (fresh tensors, never
    views of the carried state).

    ``tick_power`` is the *causal* conserved attribution: this tick's
    measured power split over the functions running in it, proportional to
    ``c * x`` under the latest estimate (post-update on boundary ticks).
    ``tick_power.sum(-1) + unattributed == w`` by construction.
    """

    tick_power: Tensor    # (B, M) conserved per-tick power (W)
    unattributed: Tensor  # (B,)   power in ticks with no activity (W)
    x: Tensor             # (B, M) estimate after processing this tick (W)
    step_completed: bool  # did this tick close a Kalman step
