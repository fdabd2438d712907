"""CPU/chip power modeling from performance counters (paper §4.3).

A linear model theta maps a function's *normalized* counter vector S to its
chip-level power:  X_CPU = theta(S).  The paper trains a linear-kernel SVR
(SmartWatts/PowerAPI-style) over the standard counters; the model stays
linear and explainable, per the paper's design requirement.  The counter
vector is the step-counter analogue (``telemetry.counters``), normalized by
the system-wide totals of the interval.

Two trainers:

- ``fit_ridge``: closed-form ridge regression (default; exact, fast).  The
  normal equations are solved in *standardized* feature space: the raw
  counter scales differ by ~1e3 (GFLOP/s vs duty cycle), which makes the
  raw-space gram ill-conditioned in float32.
- ``fit_linear_svr``: epsilon-insensitive linear SVR by subgradient descent
  on the primal, its subgradient written out by hand.

Every entry point is *fleet-batched*: a model whose ``weights``/``bias``
carry a leading ``(B,)`` node axis (one model per node, as stacked by
``stack_models`` or a batched fit) is applied to ``(B, ...)`` feature
tensors in one call, with no Python loop over nodes.  Solves go through
``torch.linalg.solve_ex``, which leaves its error flag on the device, so a
fit never waits on the card.

Model health is monitored (observed chip power vs the predicted total);
``retrain_flags`` flags drift beyond the threshold (default 5 %), the
paper's continuous-retraining signal, and ``needs_retrain`` is its scalar
form.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


class LinearPowerModel(NamedTuple):
    """theta: weights (F,) watts-per-counter + bias () watts.

    Fleet-batched models carry a leading node axis — weights ``(B, F)``,
    bias ``(B,)`` — and every predictor in this module broadcasts over it.
    """

    weights: Tensor  # (F,) per-counter watts; (B, F) for a fleet of models
    bias: Tensor     # scalar watts; (B,) for a fleet of models


@dataclasses.dataclass(frozen=True)
class CpuModelConfig:
    ridge_lambda: float = 1e-4
    svr_epsilon: float = 0.5     # watts of insensitivity
    svr_lr: float = 3e-2
    svr_iters: int = 20_000
    retrain_threshold: float = 0.05  # 5 % model error triggers retraining


def stack_models(models: Sequence[LinearPowerModel]) -> LinearPowerModel:
    """Stack per-node models into one fleet-batched ``LinearPowerModel``
    with ``weights (B, F)`` / ``bias (B,)``."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return LinearPowerModel(
        weights=torch.stack([f32(m.weights) for m in models]),
        bias=torch.stack([f32(m.bias).reshape(()) for m in models]),
    )


def model_row(model: LinearPowerModel, i: int) -> LinearPowerModel:
    """Slice node ``i``'s model out of a fleet-batched model."""
    return LinearPowerModel(weights=model.weights[i], bias=model.bias[i])


def _batched(features, power, mask):
    """Lift one node's (N, F)/(N,) inputs to a batch of one."""
    features = torch.as_tensor(features, dtype=torch.float32)
    power = torch.as_tensor(power, dtype=torch.float32, device=features.device)
    single = features.ndim == 2
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=features.device)
    if single:
        features, power = features[None], power[None]
        mask = None if mask is None else mask[None]
    return features, power, mask, single


def _unbatched(model: LinearPowerModel, single: bool) -> LinearPowerModel:
    return model_row(model, 0) if single else model


def fit_ridge(features, power, lam: float = 1e-4, *, mask=None) -> LinearPowerModel:
    """Closed-form ridge fit of power ~ features (standardized solve).

    Args:
      features: (N, F) system-interval counter vectors, or (B, N, F) for a
        fleet — one independent model per node, batched.
      power: (N,) observed chip power (watts), or (B, N).
      lam: ridge penalty on the *standardized* weights (scale-free).
      mask: optional (N,)/(B, N) sample weights — the streaming refit
        passes each node's live-window mask so a ragged fleet's dead
        windows don't drag the fit.  The moments and normal equations
        become mask-weighted, and an all-masked node degenerates to the
        zero model instead of a singular solve.

    Returns:
      ``LinearPowerModel`` with (F,)/() leaves, or (B, F)/(B,) when batched.
    """
    x, y, mask, single = _batched(features, power, mask)
    b, n, f = x.shape
    m = torch.ones((b, n), dtype=x.dtype, device=x.device) if mask is None else mask
    msum = torch.clamp(torch.sum(m, dim=1), min=1e-9)[:, None]              # (B, 1)
    x_mean = torch.sum(x * m[..., None], dim=1) / msum                       # (B, F)
    x_var = torch.sum((x - x_mean[:, None]) ** 2 * m[..., None], dim=1) / msum
    x_std = torch.clamp(torch.sqrt(x_var), min=1e-8)
    xs = (x - x_mean[:, None]) / x_std[:, None]
    xb = torch.cat([xs, torch.ones((b, n, 1), dtype=x.dtype, device=x.device)], dim=2)
    reg = lam * torch.eye(f + 1, dtype=x.dtype, device=x.device)
    # Don't penalize the bias — except, under a mask, by a vanishing epsilon
    # that keeps the gram invertible when every sample is masked out (the
    # unmasked solve is exactly the unregularized-bias one).
    reg[f, f] = 0.0 if mask is None else 1e-9
    xw = (xb * m[..., None]).transpose(1, 2)                                 # (B, F+1, N)
    theta, _ = torch.linalg.solve_ex(xw @ xb + reg, (xw @ y[..., None])[..., 0])
    w = theta[:, :f] / x_std
    bias = theta[:, f] - torch.sum(theta[:, :f] * x_mean / x_std, dim=1)
    return _unbatched(LinearPowerModel(weights=w, bias=bias), single)


def merge_models(old: LinearPowerModel, new: LinearPowerModel, flags) -> LinearPowerModel:
    """Row-wise swap of fleet-batched models: nodes with ``flags`` take
    ``new``'s (weights, bias), the rest keep ``old``'s.

    Model parameters are data to every predictor, so a swap changes no
    code path; a live session copies the result into its own model
    tensors in place, so no carried buffer moves.
    """
    f = torch.as_tensor(flags, dtype=torch.bool, device=old.weights.device)
    return LinearPowerModel(
        weights=torch.where(f[:, None], new.weights, old.weights),
        bias=torch.where(f, new.bias, old.bias),
    )


def fit_linear_svr(
    features,
    power,
    lam: float = 1e-4,
    epsilon: float = 0.5,
    lr: float = 3e-2,
    *,
    iters: int = 20_000,
) -> LinearPowerModel:
    """Linear epsilon-SVR via subgradient descent on the primal.

        loss = mean(max(|Xw + b - y| - eps, 0)) + lam/2 ||w||^2

    over standardized features, with the diminishing step
    ``lr / sqrt(1 + i)``.  The subgradient is written out (hinge side of
    each residual over N, plus ``lam * w``); ``(B, N, F)`` features with
    ``(B, N)`` power fit one independent model per node in one batched
    loop, each row following the per-node iterate path.

    Returns:
      ``LinearPowerModel`` with (F,)/() leaves, or (B, F)/(B,) when batched.
    """
    x, y, _, single = _batched(features, power, None)
    b, n, f = x.shape
    x_mean = torch.mean(x, dim=1)
    x_std = torch.clamp(torch.std(x, dim=1, correction=0), min=1e-8)
    xs = (x - x_mean[:, None]) / x_std[:, None]                              # (B, N, F)
    xs_t = xs.transpose(1, 2).contiguous()                                   # (B, F, N)
    w = torch.zeros((b, f), dtype=x.dtype, device=x.device)
    bias = torch.mean(y, dim=1)
    inv_n = 1.0 / n
    for i in range(iters):
        resid = (xs @ w[..., None])[..., 0] + bias[:, None] - y              # (B, N)
        # d/dr mean(max(|r| - eps, 0)): sign(r) / N outside the tube.
        ct = torch.where(torch.abs(resid) - epsilon > 0.0, torch.sign(resid), 0.0) * inv_n
        g_w = (xs_t @ ct[..., None])[..., 0] + lam * w
        g_b = torch.sum(ct, dim=1)
        step = float(np.float32(lr) / np.sqrt(np.float32(1.0 + i)))  # float32, as the reference
        w = w - step * g_w
        bias = bias - step * g_b
    w_raw = w / x_std
    b_raw = bias - torch.sum(w * x_mean / x_std, dim=1)
    return _unbatched(LinearPowerModel(weights=w_raw, bias=b_raw), single)


def _dynamic_power(model: LinearPowerModel, features: Tensor) -> Tensor:
    """features (..., F) x weights -> (...); fleet-batched models contract
    each node's features against that node's own weight row."""
    w = model.weights
    if w.ndim == 1:
        return features @ w
    b = w.shape[0]
    flat = features.reshape(b, -1, features.shape[-1])
    return (flat @ w[:, :, None])[..., 0].reshape(features.shape[:-1])


def _bias_like(model: LinearPowerModel, out_ndim: int) -> Tensor:
    """Bias broadcast against a (...,) prediction of rank ``out_ndim``."""
    b = model.bias
    if b.ndim == 0:
        return b
    return b.reshape(tuple(b.shape) + (1,) * (out_ndim - 1))


def predict_power(model: LinearPowerModel, features: Tensor) -> Tensor:
    """X_CPU = theta(S).  features: (..., F) -> (...,) watts.

    With a fleet-batched model (weights (B, F)), features are (B, ..., F)
    and each node is evaluated under its own model."""
    dyn = _dynamic_power(model, features)
    return dyn + _bias_like(model, dyn.ndim)


def predict_function_power_split(
    model: LinearPowerModel, fn_features: Tensor, fn_active_frac: Tensor
) -> tuple[Tensor, Tensor]:
    """Per-function chip power plus the *un-attributed* static bias.

    The bias (static chip power) is amortized over functions by activity
    fraction, so summing over functions reproduces the interval's chip
    power estimate.  On an idle interval (``sum(fn_active_frac) ~ 0``)
    there is no activity to amortize over, and the bias is returned as the
    second element for the caller to route into the report's idle term:

        sum(per_fn) + residual == relu-clamped theta(total counters)

    Args:
      fn_features: (M, F) per-function counters normalized by system
        totals, or (B, M, F) for a fleet (with a fleet-batched model).
      fn_active_frac: (M,) or (B, M) fraction of the interval each
        function was running.

    Returns:
      ``(per_fn, residual)`` — (M,)/(B, M) watts per function and the ()/
      (B,) watts of static bias left un-attributed (non-zero only on idle
      intervals).
    """
    dynamic = _dynamic_power(model, fn_features)              # (..., M)
    bias = _bias_like(model, dynamic.ndim)
    total = torch.sum(fn_active_frac, dim=-1, keepdim=True)
    has = total > 1e-9
    static_share = torch.where(has, bias * fn_active_frac / torch.where(has, total, 1.0), 0.0)
    residual = torch.where(has[..., 0], 0.0, model.bias)
    return torch.clamp(dynamic, min=0.0) + static_share, residual


def predict_function_power(
    model: LinearPowerModel, fn_features: Tensor, fn_active_frac: Tensor
) -> Tensor:
    """Per-function chip power: the attributed half of
    ``predict_function_power_split`` (callers that must conserve energy on
    idle intervals use the split form)."""
    return predict_function_power_split(model, fn_features, fn_active_frac)[0]


def model_error(model: LinearPowerModel, features: Tensor, power: Tensor, *, mask=None) -> Tensor:
    """Relative error of the model on held-out intervals (retraining signal).

    (N, F)/(N,) inputs give a scalar; fleet-batched (B, N, F)/(B, N) inputs
    give one error per node, (B,).  ``mask`` (matching ``power``) restricts
    the mean to valid intervals — a ragged fleet's dead windows score 0 and
    a node with none stays at error 0.  The single definition of the
    retraining criterion.
    """
    pred = predict_power(model, features)
    rel = torch.abs(pred - power) / torch.clamp(power, min=1e-9)
    if mask is None:
        return torch.mean(rel, dim=-1)
    m = torch.as_tensor(mask, dtype=rel.dtype, device=rel.device)
    return torch.sum(rel * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)


def retrain_flags(
    model: LinearPowerModel,
    features: Tensor,
    power: Tensor,
    config: CpuModelConfig = CpuModelConfig(),
    *,
    mask=None,
) -> Tensor:
    """Fleet retrain signal: (B,) bool, on the inputs' device (no host read).
    The streaming session evaluates it at every Kalman-step boundary, with
    ``mask`` marking each node's live windows on a ragged fleet."""
    return model_error(model, features, power, mask=mask) > config.retrain_threshold


def needs_retrain(
    model: LinearPowerModel,
    features: Tensor,
    power: Tensor,
    config: CpuModelConfig = CpuModelConfig(),
) -> bool:
    """Paper: retrain when observed-vs-predicted error exceeds 5 %."""
    return float(model_error(model, features, power)) > config.retrain_threshold
