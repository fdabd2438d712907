"""Statistical power disaggregation (paper §4.1, Eq. 1).

Estimate per-function *power* X (watts) from window-level contribution
matrices and power measurements:

    X_full    = argmin_X || C X - W ||            (Eq. 1)
    X_no_idle = argmin_X || C X - (W - W_idle) ||
    X_rest    = argmin_X || C X - (W_sys - W_cpu) ||   (combined mode, §4.3)

Two solvers, both broadcasting over leading batch dims:

- ``solve_ridge``: Tikhonov-regularized normal equations via Cholesky.
- ``solve_nnls``: projected-gradient (FISTA) non-negative least squares with
  a fixed iteration count and the step taken from the trace of the gram.

On the GPU the fixed FISTA loop is 5 small launches per iteration, so a
solve is bound by launch latency, not by the card; the engine's gram
assembly is the part owned by the CUDA kernel (``kernels.disagg_solve``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DisaggregationConfig:
    """Configuration for one disaggregation solve."""

    mode: str = "no_idle"  # full | no_idle | rest
    ridge_lambda: float = 1e-3
    nonneg: bool = True
    nnls_iters: int = 200


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def solve_ridge(
    c: torch.Tensor, w: torch.Tensor, lam: float = 1e-3, *, nonneg: bool = True
) -> torch.Tensor:
    """Closed-form ridge solution of min_X ||C X - W||^2 + lam ||X||^2.

    Args:
      c: (..., N, M) contribution matrix (seconds per window per function).
      w: (..., N) power measurements per window (watts).
      lam: Tikhonov regularizer; also what sends zero-column functions to 0.
      nonneg: clip the solution at zero (power is physical).

    Returns:
      (..., M) per-function power estimate in watts.
    """
    gram = c.mT @ c + lam * _eye(c.shape[-1], c)
    rhs = c.mT @ w[..., None]
    chol = torch.linalg.cholesky(gram)
    x = torch.cholesky_solve(rhs, chol)[..., 0]
    return torch.clamp(x, min=0.0) if nonneg else x


@functools.lru_cache(maxsize=8)
def _fista_momentum(iters: int) -> tuple[float, ...]:
    """The data-independent FISTA momentum (t_k - 1) / t_{k+1}, computed in
    float32 exactly as the reference's float32 scan carry computes it."""
    t = np.float32(1.0)
    out = []
    for _ in range(iters):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return tuple(out)


def solve_nnls_gram(gram: torch.Tensor, rhs: torch.Tensor, *, iters: int = 200) -> torch.Tensor:
    """Gram-domain FISTA NNLS: min_{X >= 0} 0.5 X^T G X - r^T X.

    ``gram`` must already include the ridge term (G = C^T C + lam I).
    Broadcasts over any leading batch dims: (..., M, M), (..., M) -> (..., M).
    """
    m = gram.shape[-1]
    batch = torch.broadcast_shapes(gram.shape[:-2], rhs.shape[:-1])
    g3 = gram.expand(batch + (m, m)).reshape(-1, m, m)
    r3 = rhs.expand(batch + (m,)).reshape(-1, m, 1)
    lip = torch.diagonal(g3, dim1=-2, dim2=-1).sum(-1)  # >= spectral norm for SPD
    step = (1.0 / torch.clamp(lip, min=1e-12))[:, None, None]
    x = torch.zeros_like(r3)
    y = x
    # Five launches per iteration: grad = G y - r, projected step, momentum.
    for coef in _fista_momentum(iters):
        grad = torch.baddbmm(r3, g3, y, beta=-1.0)
        x_new = torch.addcmul(y, step, grad, value=-1.0).clamp_(min=0.0)
        y = torch.add(x_new, x_new - x, alpha=coef)
        x = x_new
    return x.reshape(batch + (m,))


def solve_nnls(
    c: torch.Tensor, w: torch.Tensor, lam: float = 1e-3, *, iters: int = 200
) -> torch.Tensor:
    """FISTA-accelerated projected gradient NNLS.

    min_{X >= 0} 0.5||C X - W||^2 + 0.5 lam ||X||^2, with Lipschitz step
    1/L, L = ||C^T C||_2 + lam bounded by its trace (cheap, safe).
    """
    gram = c.mT @ c + lam * _eye(c.shape[-1], c)
    rhs = (c.mT @ w[..., None])[..., 0]
    return solve_nnls_gram(gram, rhs, iters=iters)


def per_invocation_energy(x_power: torch.Tensor, latency: torch.Tensor) -> torch.Tensor:
    """J = X * tau (paper §4.1): per-invocation energy in joules.

    Args:
      x_power: (M,) per-function power (watts) while running.
      latency: (M,) mean per-invocation latency (seconds).
    """
    return x_power * latency


def disaggregate(
    c: torch.Tensor,
    w: torch.Tensor,
    config: DisaggregationConfig = DisaggregationConfig(),
    *,
    w_idle: float | torch.Tensor = 0.0,
    w_cpu: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatch on disaggregation mode (paper §4.1 / §4.3).

    - ``full``: solve against raw system power W.
    - ``no_idle``: solve against W - W_idle (gives X_No_Idle / J_indiv).
    - ``rest``: solve against W_sys - W_cpu (the combined mode's residual).
    """
    if config.mode == "full":
        target = w
    elif config.mode == "no_idle":
        target = w - w_idle
    elif config.mode == "rest":
        if w_cpu is None:
            raise ValueError("mode='rest' requires w_cpu")
        target = w - w_cpu
    else:
        raise ValueError(f"unknown disaggregation mode: {config.mode!r}")
    target = torch.clamp(target, min=0.0)
    if config.nonneg:
        return solve_nnls(c, target, config.ridge_lambda, iters=config.nnls_iters)
    return solve_ridge(c, target, config.ridge_lambda, nonneg=False)
