"""Fair attribution of shared power via Shapley-value principles (paper §4.4).

FaasMeter *constructs* footprints that satisfy the four Shapley properties
(efficiency, null player, symmetry, linearity) in a best-effort manner:

- idle energy is a *static* shared resource -> split **evenly** over the
  active functions:            phi_idle = J_idle / M_active
- control-plane energy is *dynamic* (scales with use) -> split
  **per-invocation**:          phi_cp   = J_cp * A_i / sum(A)

and the full-spectrum total (Eq. 4):

    J_total = J_indiv + phi_cp + phi_idle

Every function broadcasts over leading batch dims: per-function tensors are
(..., M) and the shared energies (...).
"""

from __future__ import annotations

import torch


def shapley_idle_share(idle_energy: torch.Tensor, active_mask: torch.Tensor) -> torch.Tensor:
    """Evenly split the static idle energy over active functions; (..., M),
    zero for inactive functions (null player)."""
    active = active_mask.to(torch.float32)
    m_active = torch.clamp(torch.sum(active, dim=-1, keepdim=True), min=1.0)
    return torch.as_tensor(idle_energy)[..., None] * active / m_active


def shapley_control_plane_share(cp_energy: torch.Tensor, invocations: torch.Tensor) -> torch.Tensor:
    """phi_cp[i] = J_cp * A_i / sum(A), (..., M) in joules."""
    a = invocations.to(torch.float32)
    total = torch.clamp(torch.sum(a, dim=-1, keepdim=True), min=1.0)
    return torch.as_tensor(cp_energy)[..., None] * a / total


def total_footprint(j_indiv: torch.Tensor, phi_cp: torch.Tensor, phi_idle: torch.Tensor) -> torch.Tensor:
    """Eq. 4: J_total = J_indiv + phi_cp + phi_idle (per function, joules)."""
    return j_indiv + phi_cp + phi_idle


def per_invocation_footprint(j_total: torch.Tensor, invocations: torch.Tensor) -> torch.Tensor:
    """Footprint per single invocation: J_total / A (0 where A == 0)."""
    a = invocations.to(torch.float32)
    return torch.where(a > 0, j_total / torch.clamp(a, min=1.0), 0.0)
