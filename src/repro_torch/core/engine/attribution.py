"""Attribution stage: conserved per-tick power splits + §4.4 spectra.

``_conserved_split`` is the single source of the conservation invariant
(``tick_power.sum(-1) + unattributed == w`` by construction).
``fleet_spectrum`` assembles the Shapley footprint spectrum over the node
axis.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine.types import Tensor
from repro_torch.core.footprints import FootprintSpectrum, assemble_spectrum


def _conserved_split(raw: Tensor, w: Tensor, delta: float) -> tuple[Tensor, Tensor]:
    """Split measured power ``w`` proportional to estimated draw ``raw``.

    ``raw`` is (..., M) estimated joules per tick, ``w`` the matching (...)
    measured watts.  Ticks with vanishing predicted draw go to the
    unattributed channel: dividing by them would destroy the conservation
    invariant instead of enforcing it.
    """
    pred = torch.sum(raw, dim=-1) / delta                # (...) watts
    has = pred > 1e-9
    scale = torch.where(has, w / torch.where(has, pred, 1.0), 0.0)
    return (raw / delta) * scale[..., None], torch.where(has, 0.0, w)


def tick_attribution(
    c: Tensor,      # (B, S, n_w, M)
    w: Tensor,      # (B, S, n_w) measured active power per tick
    traj: Tensor,   # (B, S, M) per-step estimates
    *,
    delta: float = 1.0,
) -> tuple[Tensor, Tensor]:
    """Conserved per-tick power attribution (efficiency enforced per tick):
    each tick's measured power is split over the functions running in it,
    proportional to ``C[t, j] * X[j]``."""
    b, s, n_w, m = c.shape
    raw = c * traj[:, :, None, :]                       # (B, S, n_w, M) joules
    tick_power, unattributed = _conserved_split(raw, w, delta)
    return tick_power.reshape(b, s * n_w, m), unattributed.reshape(b, s * n_w)


def fleet_spectrum(
    x_power: Tensor,        # (B, M)
    mean_latency: Tensor,   # (B, M)
    invocations: Tensor,    # (B, M)
    cp_energy: Tensor,      # (B,)
    idle_energy: Tensor,    # (B,)
) -> FootprintSpectrum:
    """§4.4 spectrum assembly for the whole fleet in one batched call."""
    return assemble_spectrum(x_power, mean_latency, invocations, cp_energy, idle_energy)
