"""Masking stage: the ragged-fleet semantics folds, written once.

  ``_apply_mask``      segment inputs — tick mask + fn mask into the data;
  ``fold_step_valid``  streaming tick — per-node liveness into the data;
  ``_mask_fn_axis``    outputs — masked functions' rows forced to 0.0.

Every engine path routes through these (via ``core.engine.plan`` on the
segment side, directly on the streaming side), so the paths cannot
disagree on what a masked tick or padded function means.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine.types import FleetInputs, FleetResult, FleetStep, Tensor


def _apply_mask(inputs: FleetInputs) -> FleetInputs:
    """Fold a ragged fleet's validity masks into its data (identity if dense).

    Masked ticks get ``c = 0`` and ``w = 0`` — their gram/rhs/innovation
    contributions vanish exactly — and steps with no valid tick get zeroed
    invocation/latency statistics, which freezes the Kalman state on them.
    Masked functions get zeroed contribution columns and statistics.
    """
    if inputs.mask is None and inputs.fn_mask is None:
        return inputs
    c, w = inputs.c, inputs.w
    a, ls, lq = inputs.a, inputs.lat_sum, inputs.lat_sumsq
    if inputs.fn_mask is not None:
        fm = inputs.fn_mask.to(c.dtype)
        c = c * fm[:, None, None, :]
        a = a * fm[:, None, :]
        ls = ls * fm[:, None, :]
        lq = lq * fm[:, None, :]
    if inputs.mask is not None:
        m = inputs.mask.to(c.dtype)
        step_live = (torch.sum(m, dim=-1) > 0).to(a.dtype)[..., None]
        c = c * m[..., None]
        w = w * m
        a = a * step_live
        ls = ls * step_live
        lq = lq * step_live
    return FleetInputs(
        c=c, w=w, a=a, lat_sum=ls, lat_sumsq=lq,
        mask=inputs.mask, fn_mask=inputs.fn_mask,
    )


def fold_step_valid(step: FleetStep) -> FleetStep:
    """Fold a streaming tick's per-node liveness into its data (identity
    when ``step.valid is None``): invalid node-ticks become zero telemetry,
    so they write zero rows into the ring buffer, add nothing to the
    invocation sums and attribute exactly 0 W."""
    if step.valid is None:
        return step
    v = step.valid.to(step.c.dtype)
    return FleetStep(
        c=step.c * v[:, None], w=step.w * v,
        a=step.a * v[:, None], lat_sum=step.lat_sum * v[:, None],
        lat_sumsq=step.lat_sumsq * v[:, None],
    )


def _mask_fn_axis(result: FleetResult, fn_mask: Tensor | None) -> FleetResult:
    """Force masked functions' output rows to exactly zero (identity if dense).
    The Kalman ``state`` is left untouched (internal filter state)."""
    if fn_mask is None:
        return result
    fm = fn_mask.to(result.x_final.dtype)
    return result._replace(
        x_final=result.x_final * fm,
        x_trajectory=result.x_trajectory * fm[:, None, :],
        x0=result.x0 * fm,
        tick_power=None
        if result.tick_power is None
        else result.tick_power * fm[:, None, :],
    )
