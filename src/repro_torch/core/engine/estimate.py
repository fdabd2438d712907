"""Initial-estimate stage: whole-trace X_0 solves (§4.2) for the segment paths.

``_gram_fn`` resolves the gram-assembly backend, ``fleet_initial_estimate``
runs one batched gram-domain NNLS over the node axis, and ``_init_states``
turns the (B, M) X_0 into the batched Kalman start state.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.disaggregation import solve_nnls_gram
from repro_torch.core.engine.types import EngineConfig, Tensor
from repro_torch.core.kalman import KalmanState, kalman_init


def _gram_fn(backend: str, device: torch.device) -> Callable | None:
    """Resolve the gram-assembly backend for tensors on ``device``
    (None = the plain einsum)."""
    from repro_torch.kernels import disagg_solve

    if backend == "auto":
        backend = disagg_solve.default_backend(device)
    if backend == "kernel":
        return disagg_solve.disagg_gram
    if backend == "einsum":
        return None
    raise ValueError(f"unknown gram backend: {backend!r} (auto | einsum | kernel)")


def _node_init_gram(c_node: Tensor, w_node: Tensor) -> tuple[Tensor, Tensor]:
    """Whole-trace gram/rhs for one node via flat matmuls (the sequential
    oracle's X_0 contraction)."""
    cf = c_node.reshape(-1, c_node.shape[-1])
    return cf.T @ cf, cf.T @ w_node.reshape(-1)


def fleet_initial_estimate(
    c: Tensor, w: Tensor, config: EngineConfig = EngineConfig(), *, gram_fn=None
) -> Tensor:
    """(B, M) statistical disaggregation X_0 per node (§4.2).

    Accepts (B, N, M)/(B, N) window blocks or (B, S, n_w, M)/(B, S, n_w)
    step blocks — grams are additive over windows — and runs one batched
    gram-domain NNLS, no per-node loop.
    """
    b, m = c.shape[0], c.shape[-1]
    cf, wf = c.reshape(b, -1, m), w.reshape(b, -1)
    if gram_fn is None:
        gram, rhs = cf.mT @ cf, (cf.mT @ wf[..., None])[..., 0]
    else:
        gram, rhs = gram_fn(cf, wf)
    eye = config.init_lam * torch.eye(m, dtype=c.dtype, device=c.device)
    return solve_nnls_gram(gram + eye, rhs, iters=config.init_iters)


def _init_states(x0: Tensor) -> KalmanState:
    """Batched ``kalman_init`` from a (B, M) initial estimate."""
    return kalman_init(x0.shape[-1], x0=x0)
