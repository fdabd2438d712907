"""Energy metrology: validation metrics and marginal-energy ground truth
(paper §5.1, Table 1, Eq. 6).

External validity:
- ``individual_difference``  |J - J*| / J*            (per function)
- ``cosine_similarity``      J . J* / (|J| |J*|)      (primary external metric)
- ``marginal_energy``        Eq. 6 ground truth from paired traces

Internal validity:
- ``total_power_error``      E[ |W(t) - W_hat(t)| / W(t) ]  (efficiency proxy)
- ``latency_normalized_variance``  sigma(J) / sigma(T)
- ``coefficient_of_variation``     sigma(J) / E[J]     (pricing precision)
"""

from __future__ import annotations

import torch


def individual_difference(j: torch.Tensor, j_star: torch.Tensor) -> torch.Tensor:
    """Per-function relative difference to ground truth: |J - J*| / J*."""
    return torch.abs(j - j_star) / torch.clamp(torch.abs(j_star), min=1e-12)


def cosine_similarity(j: torch.Tensor, j_star: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between footprint vectors (ratios, robust to uniform
    offsets from idle/shared attribution policy differences)."""
    num = torch.sum(j * j_star)
    den = torch.linalg.norm(j) * torch.linalg.norm(j_star)
    return num / torch.clamp(den, min=1e-12)


def total_power_error(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """E[|W(t) - W_hat(t)| / W(t)] over windows — Shapley 'efficiency'."""
    return torch.mean(torch.abs(w - w_hat) / torch.clamp(torch.abs(w), min=1e-12))


def latency_normalized_variance(j_var: torch.Tensor, t_var: torch.Tensor) -> torch.Tensor:
    """sigma(J)/sigma(T) per function."""
    return torch.sqrt(j_var) / torch.clamp(torch.sqrt(t_var), min=1e-12)


def coefficient_of_variation(samples: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """CoV = sigma / mean along ``axis`` (population std, as ``jnp.std``)."""
    mean = torch.mean(samples, dim=axis)
    std = torch.std(samples, dim=axis, correction=0)
    return std / torch.clamp(torch.abs(mean), min=1e-12)


def marginal_energy(
    energy_full_trace: float,
    energy_without_fn: float,
    invocations_of_fn: int,
) -> float:
    """Eq. 6: M_f = ( J(T(S)) - J(T(S - f)) ) / #invocations of f in S."""
    return (energy_full_trace - energy_without_fn) / max(invocations_of_fn, 1)
