"""FleetPlan: the engine package's single composition point.

    plan = resolve_plan(inputs, config, init_c=..., init_w=...)
    x0 = plan.initial_estimate()
    ... engine-specific filter stage ...
    return finish_result(plan, final_state=..., traj=..., x0=..., with_ticks=...)

``resolve_plan`` is the entry stage (mask fold + init defaults + backend),
``finish_result`` the exit stage (conserved attribution + fn-mask fold);
an engine path contributes only its filter in between.  ``segment_plan`` is
the windowing layout shared with the profiler layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.engine.attribution import tick_attribution
from repro_torch.core.engine.estimate import _gram_fn, fleet_initial_estimate
from repro_torch.core.engine.masking import _apply_mask, _mask_fn_axis
from repro_torch.core.engine.types import EngineConfig, FleetInputs, FleetResult, Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class FleetPlan:
    """One fleet run's resolved configuration — config + folded data, once.

    ``inputs`` already has tick/fn masks folded in, ``init_c``/``init_w``
    are the resolved init block (the caller's, else the folded segment),
    and ``gram_fn`` is the resolved gram-assembly backend (None = einsum;
    only the gram-hoisted path resolves one).
    """

    config: EngineConfig
    inputs: FleetInputs       # mask-folded batch (identity when dense)
    init_c: Tensor            # (B, ..., M) init-block contributions
    init_w: Tensor            # (B, ...) init-block target power
    gram_fn: Callable | None = None

    def initial_estimate(self) -> Tensor:
        """(B, M) whole-trace X_0 over the plan's init block (§4.2)."""
        return fleet_initial_estimate(
            self.init_c, self.init_w, self.config, gram_fn=self.gram_fn
        )


def resolve_plan(
    inputs: FleetInputs,
    config: EngineConfig,
    *,
    init_c: Tensor | None = None,
    init_w: Tensor | None = None,
    use_backend: bool = False,
) -> FleetPlan:
    """Resolve one fleet run into a ``FleetPlan`` (the shared entry stage):
    fold the ragged masks into the data once, default the init block to the
    folded inputs and, for the gram-hoisted path (``use_backend=True``),
    resolve the configured gram backend for the inputs' device."""
    folded = _apply_mask(inputs)
    return FleetPlan(
        config=config,
        inputs=folded,
        init_c=folded.c if init_c is None else init_c,
        init_w=folded.w if init_w is None else init_w,
        gram_fn=_gram_fn(config.backend, folded.c.device) if use_backend else None,
    )


def finish_result(
    plan: FleetPlan,
    *,
    final_state,
    traj: Tensor,
    x0: Tensor,
    with_ticks: bool,
) -> FleetResult:
    """Assemble a ``FleetResult`` from a filter stage's outputs (exit stage):
    conserved per-tick attribution over the folded inputs (when
    ``with_ticks``) and the fn-axis output fold."""
    tick_power = unattributed = None
    if with_ticks:
        tick_power, unattributed = tick_attribution(
            plan.inputs.c, plan.inputs.w, traj, delta=plan.config.delta
        )
    return _mask_fn_axis(
        FleetResult(
            x_final=final_state.x, x_trajectory=traj, x0=x0,
            tick_power=tick_power, unattributed=unattributed,
            state=final_state,
        ),
        plan.inputs.fn_mask,
    )


def segment_plan(cfg, duration: float) -> tuple[int, int, int, int]:
    """Window accounting for one profiling segment, shared by every path.

    ``cfg`` is any config carrying ``delta`` / ``init_windows`` /
    ``step_windows``.  Returns ``(n_windows, init_n, s, n_used)``: total
    delta windows, the N_init initial-estimate block, the number of full
    Kalman steps after it, and the windows actually consumed.
    """
    n_windows = int(round(duration / cfg.delta))
    init_n = min(cfg.init_windows, n_windows)
    s = max((n_windows - init_n) // cfg.step_windows, 0)
    return n_windows, init_n, s, init_n + s * cfg.step_windows
