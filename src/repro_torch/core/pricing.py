"""Energy-based pricing for function invocations (paper §1, §4.4, §6.2) --
the twin of the reference's ``repro/core/pricing.py``.

Cloud functions today are priced by GB-seconds (memory x latency).  FaasMeter
enables *energy* (and carbon) pricing with the fair-pricing properties of
the Shapley footprints.  The price spectrum mirrors the footprint spectrum:

- ``indiv``  : J_indiv only -- what developers optimizing their function see.
- ``total``  : J_indiv + phi_cp + phi_idle -- full accounting.
- ``carbon`` : total x grid carbon intensity (gCO2/kWh).

The functions take tensors on any device and compute in float32, as the
reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

JOULES_PER_KWH = 3.6e6


@dataclasses.dataclass(frozen=True)
class PricingConfig:
    usd_per_kwh: float = 0.12
    carbon_intensity_g_per_kwh: float = 400.0  # grid average
    # Latency-based comparison price (AWS-Lambda-like): $ per GB-second.
    usd_per_gb_second: float = 1.667e-5


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def energy_price_usd(j_total: Tensor, usd_per_kwh: float = 0.12) -> Tensor:
    """Price (USD) per function over the accounting period from joules."""
    return _f32(j_total) / JOULES_PER_KWH * usd_per_kwh


def carbon_footprint_g(j_total: Tensor, intensity_g_per_kwh: float = 400.0) -> Tensor:
    """Operational carbon: energy x grid carbon intensity."""
    return _f32(j_total) / JOULES_PER_KWH * intensity_g_per_kwh


def latency_price_usd(latency_s: Tensor, mem_gb: Tensor, usd_per_gb_second: float = 1.667e-5) -> Tensor:
    """Status-quo GB-second pricing, the paper's comparison baseline."""
    return _f32(latency_s) * _f32(mem_gb) * usd_per_gb_second


def price_report(
    j_indiv: Tensor,
    j_total: Tensor,
    invocations: Tensor,
    latency_s: Tensor,
    mem_gb: Tensor,
    config: PricingConfig = PricingConfig(),
) -> dict:
    """Per-function price table across the pricing spectrum."""
    inv = torch.clamp(_f32(invocations), min=1.0)
    j_indiv, j_total = _f32(j_indiv), _f32(j_total)
    return {
        "indiv_usd_per_inv": energy_price_usd(j_indiv / inv, config.usd_per_kwh),
        "total_usd_per_inv": energy_price_usd(j_total / inv, config.usd_per_kwh),
        "carbon_g_per_inv": carbon_footprint_g(j_total / inv, config.carbon_intensity_g_per_kwh),
        "latency_usd_per_inv": latency_price_usd(latency_s, mem_gb, config.usd_per_gb_second),
    }


class LivePriceMeter:
    """Running per-function bill, accumulated tick-by-tick (§4.4, §6.2).

    The streaming twin of ``price_report``: every conserved engine tick
    (attributed watts x tick seconds, invocation starts) is folded into
    per-function joules, so the bill is current during the segment.  Idle
    energy accrues continuously and is shared evenly over the functions
    seen so far, which keeps conservation exact at every instant:

        sum_f (j_indiv_f + idle_share_f)  ==  sum_f j_indiv_f + idle_watts * elapsed
    """

    def __init__(self, num_fns: int, config: PricingConfig = PricingConfig()):
        self.num_fns = num_fns
        self.config = config
        self.j_indiv = np.zeros(num_fns)      # cumulative attributed joules
        self.invocations = np.zeros(num_fns)  # cumulative invocation starts
        self.idle_joules = 0.0
        self.elapsed_s = 0.0
        self.ticks_seen = 0

    def observe_tick(
        self,
        tick_power: np.ndarray,   # (M+,) attributed watts for the tick
        a_tick: np.ndarray,       # (M+,) invocations starting in the tick
        tick_seconds: float,
        idle_watts: float = 0.0,
    ) -> None:
        """Fold one conserved engine tick into the running bill; entries
        past ``num_fns`` (shared principals) are ignored."""
        self.j_indiv += np.asarray(tick_power[: self.num_fns], float) * tick_seconds
        self.invocations += np.asarray(a_tick[: self.num_fns], float)
        self.idle_joules += idle_watts * tick_seconds
        self.elapsed_s += tick_seconds
        self.ticks_seen += 1

    @property
    def j_total(self) -> np.ndarray:
        """(M,) total joules: attributed + even idle share over the
        functions invoked so far (zero for never-invoked functions)."""
        active = self.invocations > 0
        n_active = max(int(active.sum()), 1)
        return self.j_indiv + np.where(active, self.idle_joules / n_active, 0.0)

    def report(self, latency_s, mem_gb) -> dict:
        """Current per-invocation price table -- ``price_report`` over the
        running totals (same spectrum, live numbers)."""
        return price_report(
            _f32(self.j_indiv), _f32(self.j_total), _f32(self.invocations),
            _f32(latency_s), _f32(mem_gb), self.config,
        )
