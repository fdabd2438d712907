"""Footprint-aware software power capping (paper §5, Fig. 10).

Admission rule for the function at the head of the queue, using its
FaasMeter footprint J_lambda as the predicted energy increment:

    admit lambda  iff  W * t + J_lambda  <=  W_cap * t

where W is the current system power and t the control interval.  Without
footprints the fallback is a static buffer:  admit iff W + b < W_cap —
which either overshoots (b small) or queues needlessly (b large); the
footprint-aware rule achieves <3 % overshoot in the paper.

The controller is control-plane-side host logic (plain Python and NumPy)
because admission interleaves with scheduling; the scheduler in
``repro_torch.serving.scheduler`` consults it per dequeue.  A copy of the
reference's module, which imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CappingConfig:
    power_cap_watts: float = float("inf")
    control_interval_s: float = 1.0
    # Fallback static buffer (watts) when a function has no footprint yet.
    static_buffer_watts: float = 20.0
    use_footprints: bool = True
    # Guard band: admit against cap*(1-guard) to absorb footprint-estimate
    # error (FaasMeter footprints are estimates, not oracles).  The band
    # adapts AIMD-style: +increase on every observed violation, slow decay
    # on clean samples — converging to the workload's actual estimate error
    # (beyond-paper refinement; the paper uses a fixed rule).
    guard_band: float = 0.02
    guard_increase: float = 0.01
    guard_decay: float = 0.0005
    guard_max: float = 0.20


@dataclasses.dataclass
class CapStats:
    decisions: int = 0
    admitted: int = 0
    deferred: int = 0
    overshoot_samples: int = 0
    power_samples: int = 0
    max_overshoot_frac: float = 0.0
    sum_overshoot_frac: float = 0.0

    @property
    def overshoot_fraction(self) -> float:
        """Fraction of power samples above the cap."""
        return self.overshoot_samples / max(self.power_samples, 1)

    @property
    def mean_overshoot_magnitude(self) -> float:
        """Mean relative magnitude of cap violations (0 if none)."""
        return self.sum_overshoot_frac / max(self.overshoot_samples, 1)


class PowerCapController:
    """Stateful admission controller + overshoot bookkeeping."""

    def __init__(self, config: CappingConfig):
        self.config = config
        self.stats = CapStats()
        self._current_power = 0.0
        self._guard = config.guard_band

    def observe_power(self, watts: float) -> None:
        """Feed a system power sample; tracks cap violations and adapts the
        guard band (AIMD: widen on violation, decay when clean)."""
        self._current_power = watts
        self.stats.power_samples += 1
        cap = self.config.power_cap_watts
        if watts > cap:
            over = (watts - cap) / cap
            self.stats.overshoot_samples += 1
            self.stats.sum_overshoot_frac += over
            self.stats.max_overshoot_frac = max(self.stats.max_overshoot_frac, over)
            self._guard = min(
                self._guard + self.config.guard_increase + over, self.config.guard_max
            )
        else:
            self._guard = max(self._guard - self.config.guard_decay, self.config.guard_band)

    @property
    def headroom_watts(self) -> float:
        """Admission headroom under the guarded cap at the current power
        sample (negative when already over it); +inf when uncapped."""
        if self.config.power_cap_watts == float("inf"):
            return float("inf")
        return self.config.power_cap_watts * (1.0 - self._guard) - self._current_power

    def _decision(
        self, footprint_joules: float | None, duration_s: float | None
    ) -> tuple[bool, float | None]:
        """The admission predicate, shared by ``admit`` and ``would_admit``:
        ``(ok, j_interval)`` where j_interval is the optimistic energy charge
        (None on the static-buffer fallback and the uncapped case)."""
        if self.config.power_cap_watts == float("inf"):
            return True, None
        cap = self.config.power_cap_watts * (1.0 - self._guard)
        t = self.config.control_interval_s
        w = self._current_power
        if self.config.use_footprints and footprint_joules is not None:
            j_interval = footprint_joules
            if duration_s is not None and duration_s > t:
                j_interval = footprint_joules * t / duration_s
            return w * t + j_interval <= cap * t, j_interval
        return w + self.config.static_buffer_watts < cap, None

    def would_admit(
        self, footprint_joules: float | None, duration_s: float | None = None
    ) -> bool:
        """Pure admission probe: the same rule as ``admit`` with *no* side
        effects — no stats, no optimistic power accounting.  Placement uses
        it to test candidate nodes without charging the losers."""
        return self._decision(footprint_joules, duration_s)[0]

    def admit(self, footprint_joules: float | None, duration_s: float | None = None) -> bool:
        """Head-of-queue admission decision (paper: W*t + J_lambda <= W_cap*t).

        Args:
          footprint_joules: FaasMeter per-invocation footprint J_lambda for
            the candidate function; None if unknown (cold function).
          duration_s: expected invocation duration tau.  Only the energy the
            function deposits *within the control interval* counts:
            J_interval = J * min(t/tau, 1).  For tau <= t this is the
            paper's rule verbatim; for long functions it is the physical
            power increment J/tau (the paper's functions are all <= ~8 s at
            t = 1 s, where the distinction is negligible).
        """
        self.stats.decisions += 1
        ok, j_interval = self._decision(footprint_joules, duration_s)
        if ok:
            self.stats.admitted += 1
            # Optimistically account for the admitted function's power so a
            # burst of admissions within one control interval can't blow
            # through the cap before the next power sample arrives.
            if j_interval is not None:
                self._current_power += j_interval / self.config.control_interval_s
        else:
            self.stats.deferred += 1
        return ok


class FleetPowerCapController:
    """B per-node ``PowerCapController``s behind one fleet-shaped facade.

    The streaming control loop observes a (B,) power vector per tick and
    admits invocations onto individual nodes; this facade keeps each node's
    AIMD guard band and overshoot bookkeeping independent (a noisy node must
    not widen a quiet node's guard) while exposing fleet-level aggregates.
    """

    def __init__(self, config: CappingConfig, num_nodes: int):
        self.config = config
        self.nodes = [PowerCapController(config) for _ in range(num_nodes)]

    def observe_power(self, watts, valid=None) -> None:
        """Feed one (B,) fleet power sample; ``valid`` (B,) bool masks nodes
        whose stream has ended (ragged fleets) out of the statistics."""
        for i, ctl in enumerate(self.nodes):
            if valid is None or valid[i]:
                ctl.observe_power(float(watts[i]))

    def headroom_watts(self):
        """(B,) guarded-cap headroom per node (placement sort key)."""
        return np.asarray([ctl.headroom_watts for ctl in self.nodes])

    def would_admit(
        self, node: int, footprint_joules: float | None, duration_s: float | None = None
    ) -> bool:
        """Pure per-node admission probe (no stats, no power charge)."""
        return self.nodes[node].would_admit(footprint_joules, duration_s)

    def admit(
        self, node: int, footprint_joules: float | None, duration_s: float | None = None
    ) -> bool:
        """Admit onto ``node`` (stats + optimistic accounting on that node)."""
        return self.nodes[node].admit(footprint_joules, duration_s)

    @property
    def stats(self) -> CapStats:
        """Fleet-aggregate ``CapStats`` (sums over nodes; max of maxes)."""
        agg = CapStats()
        for ctl in self.nodes:
            s = ctl.stats
            agg.decisions += s.decisions
            agg.admitted += s.admitted
            agg.deferred += s.deferred
            agg.overshoot_samples += s.overshoot_samples
            agg.power_samples += s.power_samples
            agg.sum_overshoot_frac += s.sum_overshoot_frac
            agg.max_overshoot_frac = max(agg.max_overshoot_frac, s.max_overshoot_frac)
        return agg
