"""Full-spectrum footprint assembly (paper §4.4, Fig. 3's spectrum).

A function's total energy profile comprises its *individual* contribution,
its share of *control plane* energy, and its share of the server's *idle*
energy.  ``assemble_spectrum`` broadcasts over a leading node axis, so the
fleet form is the same call on (B, M) inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.shapley import (
    per_invocation_footprint,
    shapley_control_plane_share,
    shapley_idle_share,
    total_footprint,
)


class FootprintSpectrum(NamedTuple):
    """Per-function energy accounting over a period (all joules, (..., M))."""

    j_indiv: torch.Tensor          # individual energy (no idle): X_no_idle * tau * A
    phi_cp: torch.Tensor           # Shapley share of control-plane energy
    phi_idle: torch.Tensor         # Shapley share of idle energy
    j_total: torch.Tensor          # Eq. 4 total
    per_invocation: torch.Tensor   # J_total / A
    per_invocation_indiv: torch.Tensor  # J_indiv / A (developer-facing footprint)


def assemble_spectrum(
    x_power: torch.Tensor,        # (..., M) per-function power while running (no idle)
    mean_latency: torch.Tensor,   # (..., M) mean invocation latency (s)
    invocations: torch.Tensor,    # (..., M) invocation counts over the period
    cp_energy: torch.Tensor,      # (...) control-plane energy over the period (J)
    idle_energy: torch.Tensor,    # (...) idle energy over the period (J)
) -> FootprintSpectrum:
    """Assemble the full footprint spectrum for an accounting period."""
    a = invocations.to(torch.float32)
    j_indiv = x_power * mean_latency * a          # J = X * tau  (§4.1), times A
    phi_cp = shapley_control_plane_share(cp_energy, a)
    phi_idle = shapley_idle_share(idle_energy, a > 0)
    j_total = total_footprint(j_indiv, phi_cp, phi_idle)
    return FootprintSpectrum(
        j_indiv=j_indiv,
        phi_cp=phi_cp,
        phi_idle=phi_idle,
        j_total=j_total,
        per_invocation=per_invocation_footprint(j_total, a),
        per_invocation_indiv=per_invocation_footprint(j_indiv, a),
    )
