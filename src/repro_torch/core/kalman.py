"""Online estimation with Kalman filtering (paper §4.2, Fig. 4).

Per Kalman step i (N_K ~ 1-2 min of delta-sized windows):

    U_i = argmin_X || C_i X - W_i ||          (fresh disaggregation)
    Z_i = W_i - C_i X_hat_{i-1}               (innovation)
    P   = alpha * P_{i-1} + gamma * sigma(T)  (process noise)
    K   = P A_i^T / (A_i P A_i^T + r)         (gain; r ~ 1/delta)
    P_i = (1 - K A_i) P
    X_i = alpha X_hat_{i-1} + beta U_i + K Z_i

Functions not executed in a step keep their footprint (masked update);
new functions take the fresh estimate directly.

Every function here broadcasts over leading batch dims, which is the
reference's ``vmap`` over nodes written out: a ``KalmanState`` whose leaves
are (B, M) is B independent filters.  The reference's ``lax.scan`` over
steps is a Python loop over the step axis, batched over nodes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.disaggregation import solve_nnls, solve_nnls_gram
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    alpha: float = 0.8  # memory on the previous estimate
    beta: float = 0.2   # weight on the fresh disaggregation U_i
    gamma: float = 0.1  # weight of latency variance in process noise
    delta: float = 1.0  # measurement window (s); r proportional to 1/delta
    ridge_lambda: float = 1e-3
    nnls_iters: int = 200
    r_scale: float = 1.0  # measurement noise r = r_scale / delta


class KalmanState(NamedTuple):
    x: torch.Tensor          # (..., M) per-function power estimate (watts)
    p: torch.Tensor          # (..., M) process-noise variance (diagonal)
    seen: torch.Tensor       # (..., M) bool: has the function ever been active
    lat_mean: torch.Tensor   # (..., M) running mean of latency (Welford)
    lat_m2: torch.Tensor     # (..., M) running sum of squared deviations
    lat_count: torch.Tensor  # (..., M) number of latency observations


def kalman_init(
    num_fns: int,
    x0: torch.Tensor | None = None,
    p0: float = 1.0,
    *,
    device: str | torch.device = DEFAULT_DEVICE,
) -> KalmanState:
    """Initial state.  ``x0`` (shape (..., M)) comes from statistical
    disaggregation over the initial block (§4.2); the state lands on its
    device.  Without ``x0`` the state is all-zero on ``device``."""
    if x0 is None:
        x = torch.zeros((num_fns,), dtype=torch.float32, device=resolve_device(device))
        seen = torch.zeros_like(x, dtype=torch.bool)
    else:
        x = x0.to(torch.float32)
        seen = x > 0
    zeros = torch.zeros_like(x)
    return KalmanState(
        x=x, p=torch.full_like(x, p0), seen=seen,
        lat_mean=zeros, lat_m2=zeros, lat_count=zeros,
    )


def _welford_update(state: KalmanState, lat_sum, lat_sumsq, n):
    """Batch Welford merge of per-step latency moments into the running ones."""
    n_old = state.lat_count
    n_new = n_old + n
    safe = torch.clamp(n_new, min=1.0)
    batch_mean = lat_sum / torch.clamp(n, min=1.0)
    delta = batch_mean - state.lat_mean
    mean = torch.where(n > 0, state.lat_mean + delta * n / safe, state.lat_mean)
    batch_m2 = torch.clamp(lat_sumsq - n * batch_mean**2, min=0.0)
    m2 = torch.where(
        n > 0, state.lat_m2 + batch_m2 + delta**2 * n_old * n / safe, state.lat_m2
    )
    return mean, m2, n_new


def latency_variance(state: KalmanState) -> torch.Tensor:
    """sigma^2(T): running per-function latency variance."""
    return state.lat_m2 / torch.clamp(state.lat_count - 1.0, min=1.0)


def _apply_update(
    state: KalmanState,
    u: torch.Tensor,      # (..., M) fresh disaggregation U_i
    z: torch.Tensor,      # (...) innovation
    a_step: torch.Tensor,
    lat_sum: torch.Tensor,
    lat_sumsq: torch.Tensor,
    config: KalmanConfig,
) -> tuple[KalmanState, torch.Tensor]:
    """Shared gain/covariance/masked-update tail of one Kalman step (both
    the raw windowed step and the gram-hoisted step call this)."""
    alpha, beta, gamma = config.alpha, config.beta, config.gamma
    r = config.r_scale / config.delta
    active = a_step > 0

    mean, m2, n_new = _welford_update(state, lat_sum, lat_sumsq, a_step)
    sigma_t = m2 / torch.clamp(n_new - 1.0, min=1.0)
    p = alpha * state.p + gamma * sigma_t

    # K_j A_j = P_j A_j^2 / (sum_i P_i A_i^2 + r) <= 1; the clamp guards the
    # float32 edge so P stays PSD over arbitrarily long horizons.
    apat = torch.sum(a_step * p * a_step, dim=-1, keepdim=True)
    k = p * a_step / (apat + r)
    # 1 - K A cancels catastrophically as the gain saturates.  Round it once,
    # as the reference's fused multiply-add does: the float32 product is
    # exact in float64, so only the final cast rounds.
    one_minus_ka = (1.0 - k.double() * a_step.double()).to(p.dtype)
    p_new = torch.clamp(one_minus_ka * p, min=0.0)

    x_update = alpha * state.x + beta * u + k * z[..., None]
    # New functions (first activity): take the fresh estimate directly.
    is_new = active & (~state.seen)
    x_update = torch.where(is_new, u, x_update)
    # Inactive functions: footprint unchanged.
    x_new = torch.where(active, torch.clamp(x_update, min=0.0), state.x)
    p_new = torch.where(active, p_new, state.p)

    new_state = KalmanState(
        x=x_new, p=p_new, seen=state.seen | active,
        lat_mean=mean, lat_m2=m2, lat_count=n_new,
    )
    return new_state, x_new


def kalman_step(
    state: KalmanState,
    c_step: torch.Tensor,     # (..., n_w, M) contribution windows in this step
    w_step: torch.Tensor,     # (..., n_w)  power measurements (idle-adjusted)
    a_step: torch.Tensor,     # (..., M)    invocation counts in this step
    lat_sum: torch.Tensor,    # (..., M)    sum of latencies in step
    lat_sumsq: torch.Tensor,  # (..., M)    sum of squared latencies
    config: KalmanConfig = KalmanConfig(),
) -> tuple[KalmanState, torch.Tensor]:
    """One Kalman update (Fig. 4).  Returns (new_state, X_hat_i)."""
    u = solve_nnls(c_step, w_step, config.ridge_lambda, iters=config.nnls_iters)
    # Innovation: mean residual of the previous estimate on new measurements.
    resid = w_step - (c_step @ state.x[..., None])[..., 0]
    window_active = (torch.sum(c_step, dim=-1) > 0).to(resid.dtype)
    z = torch.sum(resid * window_active, dim=-1) / torch.clamp(
        torch.sum(window_active, dim=-1), min=1.0
    )
    return _apply_update(state, u, z, a_step, lat_sum, lat_sumsq, config)


def _scan(step_fn, state: KalmanState, xs: tuple, axis: int):
    """``lax.scan`` over ``axis`` of every tensor in ``xs``: returns the final
    state and the per-step estimates stacked back on ``axis``."""
    traj = []
    for i in range(xs[0].shape[axis]):
        state, x = step_fn(state, *(t.select(axis, i) for t in xs))
        traj.append(x)
    return state, torch.stack(traj, dim=axis)


def run_kalman(
    state: KalmanState,
    c_steps: torch.Tensor,     # (S, n_w, M)
    w_steps: torch.Tensor,     # (S, n_w)
    a_steps: torch.Tensor,     # (S, M)
    lat_sums: torch.Tensor,    # (S, M)
    lat_sumsqs: torch.Tensor,  # (S, M)
    config: KalmanConfig = KalmanConfig(),
) -> tuple[KalmanState, torch.Tensor]:
    """Run ``kalman_step`` over S sequential steps; returns the final state
    and the (S, M) trajectory."""
    step = lambda st, c, w, a, ls, lq: kalman_step(st, c, w, a, ls, lq, config)
    return _scan(step, state, (c_steps, w_steps, a_steps, lat_sums, lat_sumsqs), 0)


def run_kalman_fleet(
    states: KalmanState,       # leading node axis B on every leaf
    c_steps: torch.Tensor,     # (B, S, n_w, M)
    w_steps: torch.Tensor,     # (B, S, n_w)
    a_steps: torch.Tensor,     # (B, S, M)
    lat_sums: torch.Tensor,    # (B, S, M)
    lat_sumsqs: torch.Tensor,  # (B, S, M)
    config: KalmanConfig = KalmanConfig(),
) -> tuple[KalmanState, torch.Tensor]:
    """Whole-fleet Kalman: every node's step sequence in one loop over steps,
    batched over nodes.  Returns the final states and (B, S, M) trajectories."""
    step = lambda st, c, w, a, ls, lq: kalman_step(st, c, w, a, ls, lq, config)
    return _scan(step, states, (c_steps, w_steps, a_steps, lat_sums, lat_sumsqs), 1)


class KalmanStepInputs(NamedTuple):
    """Per-step sufficient statistics with the window dimension pre-reduced.

    All three window-touching terms of ``kalman_step`` (gram, rhs,
    innovation) are linear in the windows, so they are hoisted out of the
    step loop into one batched pass — the CUDA gram kernel
    (``kernels.disagg_solve``) owns that pass on the card — and the loop
    then carries only O(M^2) work per step.
    """

    gram: torch.Tensor       # (..., M, M) C^T C + lam I per step
    rhs: torch.Tensor        # (..., M)    C^T W per step
    s_w: torch.Tensor        # (...)       sum of W over active windows
    s_c: torch.Tensor        # (..., M)    column sums of C over active windows
    n_act: torch.Tensor      # (...)       number of active windows
    a: torch.Tensor          # (..., M)    invocation counts
    lat_sum: torch.Tensor    # (..., M)
    lat_sumsq: torch.Tensor  # (..., M)


def precompute_step_inputs(
    c_steps: torch.Tensor,     # (..., n_w, M) with any leading batch dims
    w_steps: torch.Tensor,     # (..., n_w)
    a_steps: torch.Tensor,
    lat_sums: torch.Tensor,
    lat_sumsqs: torch.Tensor,
    config: KalmanConfig = KalmanConfig(),
    *,
    gram_fn=None,
) -> KalmanStepInputs:
    """Reduce the window dimension for every step in one batched pass.

    ``gram_fn(c, w) -> (gram, rhs)`` over flattened (G, n_w, M)/(G, n_w)
    blocks selects the assembly backend (the CUDA kernel); the default is a
    pair of einsum contractions.
    """
    m = c_steps.shape[-1]
    if gram_fn is None:
        gram = torch.einsum("...nm,...nk->...mk", c_steps, c_steps)
        rhs = torch.einsum("...nm,...n->...m", c_steps, w_steps)
    else:
        lead = c_steps.shape[:-2]
        gram, rhs = gram_fn(
            c_steps.reshape((-1,) + tuple(c_steps.shape[-2:])),
            w_steps.reshape(-1, w_steps.shape[-1]),
        )
        gram = gram.reshape(lead + (m, m))
        rhs = rhs.reshape(lead + (m,))
    gram = gram + config.ridge_lambda * torch.eye(m, dtype=gram.dtype, device=gram.device)
    wa = (torch.sum(c_steps, dim=-1) > 0).to(c_steps.dtype)
    return KalmanStepInputs(
        gram=gram,
        rhs=rhs,
        s_w=torch.sum(w_steps * wa, dim=-1),
        s_c=torch.einsum("...nm,...n->...m", c_steps, wa),
        n_act=torch.sum(wa, dim=-1),
        a=a_steps,
        lat_sum=lat_sums,
        lat_sumsq=lat_sumsqs,
    )


def kalman_step_gram(
    state: KalmanState,
    inp: KalmanStepInputs,   # one step: gram (..., M, M), rhs (..., M), ...
    config: KalmanConfig = KalmanConfig(),
) -> tuple[KalmanState, torch.Tensor]:
    """``kalman_step`` on pre-reduced window statistics (same update rule)."""
    u = solve_nnls_gram(inp.gram, inp.rhs, iters=config.nnls_iters)
    # sum_w (W - C X) * active = s_w - s_c . X.
    z = (inp.s_w - torch.sum(inp.s_c * state.x, dim=-1)) / torch.clamp(inp.n_act, min=1.0)
    return _apply_update(state, u, z, inp.a, inp.lat_sum, inp.lat_sumsq, config)


def _gram_scan(state: KalmanState, inputs: KalmanStepInputs, config, axis: int):
    step = lambda st, *leaves: kalman_step_gram(st, KalmanStepInputs(*leaves), config)
    return _scan(step, state, tuple(inputs), axis)


def run_kalman_gram(
    state: KalmanState,
    inputs: KalmanStepInputs,   # leading (S,) on every leaf
    config: KalmanConfig = KalmanConfig(),
) -> tuple[KalmanState, torch.Tensor]:
    """Single-node loop over pre-reduced steps."""
    return _gram_scan(state, inputs, config, 0)


def run_kalman_fleet_gram(
    states: KalmanState,        # leading node axis B
    inputs: KalmanStepInputs,   # leading (B, S) on every leaf
    config: KalmanConfig = KalmanConfig(),
) -> tuple[KalmanState, torch.Tensor]:
    """Fleet loop over pre-reduced steps: the O(M^2)-per-step hot path."""
    return _gram_scan(states, inputs, config, 1)
