"""Ground-truth node power model (simulator side).

True node power on a fine time grid:

    P(t) = P_idle + g( sum_j act[t, j] * p_j ) + P_cp(t)

- ``act`` is the (T, M) concurrent-invocation activity series;
- ``p_j`` is function j's true dynamic draw per concurrent invocation;
- ``g`` is a mild sublinear compression modeling shared power states
  (voltage/frequency scaling under load — why the paper's Fig. 3 isolated
  footprints depend on load, and why Fig. 11 neighbors move footprints by a
  few percent);
- ``P_cp`` is the control plane: a base draw plus per-invocation handling
  work (the paper: up to 600 ms of control-plane time per invocation on
  OpenWhisk; Iluvatar ~ a few ms-scale, here configurable).

The *chip* power (RAPL-like view) sees only each function's ``cpu_frac``
share of its dynamic power plus the chip idle floor.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerModelConfig:
    idle_w: float = 95.0            # paper's server idles at 95 W
    chip_idle_w: float = 40.0       # chip floor, part of idle_w
    sublinearity: float = 0.97      # g(p) = p * (p / p_ref)^(s-1); 1.0 = linear
    sublinear_ref_w: float = 100.0
    cp_base_w: float = 3.0          # control-plane resident draw
    cp_per_inv_j: float = 0.8       # control-plane joules of work per invocation
    cp_handling_s: float = 0.05     # spread of that work around each start
    cp_cpu_capacity_w: float = 30.0 # watts == 100 % of one control-plane core


class NodePowerModel:
    """Computes true power series from activity; numpy, simulator-side only."""

    def __init__(self, config: PowerModelConfig, dyn_power_w: np.ndarray, cpu_frac: np.ndarray):
        self.config = config
        self.dyn_power_w = np.asarray(dyn_power_w, np.float64)   # (M,)
        self.cpu_frac = np.asarray(cpu_frac, np.float64)         # (M,)

    def _compress(self, p_dyn: np.ndarray) -> np.ndarray:
        s = self.config.sublinearity
        if s >= 1.0:
            return p_dyn
        ref = self.config.sublinear_ref_w
        return np.where(p_dyn > 0, p_dyn * (np.maximum(p_dyn, 1e-9) / ref) ** (s - 1.0), 0.0)

    def control_plane_power(self, starts: np.ndarray, t_grid: np.ndarray, dt: float) -> np.ndarray:
        """(T,) control-plane draw: base + per-invocation handling work
        spread uniformly over ``cp_handling_s`` after each start."""
        cfg = self.config
        cp = np.full(t_grid.shape, cfg.cp_base_w, np.float64)
        if starts.size:
            width = max(cfg.cp_handling_s, dt)
            w_power = cfg.cp_per_inv_j / width
            idx0 = np.floor(starts / dt).astype(np.int64)
            nbins = max(int(np.ceil(width / dt)), 1)
            for k in range(nbins):
                idx = idx0 + k
                ok = (idx >= 0) & (idx < t_grid.shape[0])
                np.add.at(cp, idx[ok], w_power)
        return cp

    def system_power(
        self, activity: np.ndarray, cp_power: np.ndarray, *, p_dyn: np.ndarray | None = None
    ) -> np.ndarray:
        """(T,) true full-system power.  ``p_dyn`` lets the fleet simulator
        pass the dynamic-power contraction it already batched over nodes."""
        if p_dyn is None:
            p_dyn = activity @ self.dyn_power_w
        return self.config.idle_w + self._compress(p_dyn) + cp_power

    def chip_power(
        self, activity: np.ndarray, cp_power: np.ndarray, *, p_cpu: np.ndarray | None = None
    ) -> np.ndarray:
        """(T,) true chip power (what a RAPL-like sensor measures)."""
        if p_cpu is None:
            p_cpu = activity @ (self.dyn_power_w * self.cpu_frac)
        return self.config.chip_idle_w + self._compress(p_cpu) + cp_power

    def cp_cpu_fraction(self, cp_power: np.ndarray) -> np.ndarray:
        """Control-plane CPU utilization fraction (for Eq. 2)."""
        dyn = np.maximum(cp_power - 0.0, 0.0)
        return np.clip(dyn / self.config.cp_cpu_capacity_w, 0.0, 1.0)

    def sys_cpu_fraction(self, activity: np.ndarray, cp_power: np.ndarray) -> np.ndarray:
        """System-wide CPU utilization proxy used to normalize Eq. 2.

        The capacity is the control-plane capacity plus the observed busy
        peak; a zero-length activity series yields an empty fraction series
        (``np.max`` on it would crash), and a degenerate non-positive
        capacity falls back to 1 W so the division stays defined.
        """
        busy = activity @ (self.dyn_power_w * self.cpu_frac) + cp_power
        peak = float(np.max(busy)) if busy.size else 0.0
        cap = self.config.cp_cpu_capacity_w + peak
        if cap <= 0.0:
            cap = 1.0
        return np.clip(busy / cap, 1e-3, 1.0)


class FleetPowerModel:
    """Heterogeneous-fleet twin of ``NodePowerModel``: every per-node
    ``PowerModelConfig`` field is stacked as a ``(B,)`` array, so a mixed
    server/desktop/edge fleet runs through ONE vectorized truth pass — the
    platform mix is data, not a Python loop over per-node models.

    All methods take/return ``(B, T)`` fine-grid series.  Each row is
    bitwise what the corresponding ``NodePowerModel`` would produce (the
    elementwise kernels are identical; reductions stay per-row), which is
    what lets a mixed fleet pin against per-platform batches exactly.
    """

    _FIELDS = (
        "idle_w", "chip_idle_w", "sublinearity", "sublinear_ref_w",
        "cp_base_w", "cp_per_inv_j", "cp_handling_s", "cp_cpu_capacity_w",
    )

    def __init__(
        self,
        configs: "list[PowerModelConfig]",
        dyn_power_w: np.ndarray,
        cpu_frac: np.ndarray,
    ):
        if not configs:
            raise ValueError("FleetPowerModel needs at least one node config")
        self.configs = tuple(configs)
        self.b = len(configs)
        for name in self._FIELDS:
            setattr(
                self, name,
                np.asarray([getattr(c, name) for c in configs], np.float64),
            )
        self.dyn_power_w = np.asarray(dyn_power_w, np.float64)   # (M,) shared
        self.cpu_frac = np.asarray(cpu_frac, np.float64)         # (M,) shared

    def node(self, i: int) -> NodePowerModel:
        """Per-node view (the scalar model this row is pinned against)."""
        return NodePowerModel(self.configs[i], self.dyn_power_w, self.cpu_frac)

    def _compress(self, p_dyn: np.ndarray) -> np.ndarray:
        """(B, T) sublinear compression with per-node ``sublinearity``;
        linear rows (s >= 1) pass through untouched, as data."""
        s = self.sublinearity[:, None]
        ref = self.sublinear_ref_w[:, None]
        curved = np.where(
            p_dyn > 0, p_dyn * (np.maximum(p_dyn, 1e-9) / ref) ** (s - 1.0), 0.0
        )
        return np.where(s >= 1.0, p_dyn, curved)

    def control_plane_power(
        self, starts: "list[np.ndarray]", num_bins: int, dt: float
    ) -> np.ndarray:
        """(B, T) control-plane draw: per-node base + per-invocation handling
        work, all nodes' events scattered in one ``np.add.at`` pass per
        handling bin.  ``starts[i]`` are node i's valid invocation starts."""
        cp = np.empty((self.b, num_bins), np.float64)
        cp[:] = self.cp_base_w[:, None]
        sizes = [np.asarray(s).shape[0] for s in starts]
        if not any(sizes):
            return cp
        bidx = np.concatenate(
            [np.full(n, i, np.int64) for i, n in enumerate(sizes)]
        )
        st = np.concatenate([np.asarray(s) for s in starts])
        width = np.maximum(self.cp_handling_s, dt)               # (B,)
        w_power = (self.cp_per_inv_j / width)[bidx]              # per event
        nbins = np.maximum(np.ceil(width / dt).astype(np.int64), 1)[bidx]
        idx0 = np.floor(st / dt).astype(np.int64)
        for k in range(int(nbins.max())):
            idx = idx0 + k
            ok = (k < nbins) & (idx >= 0) & (idx < num_bins)
            np.add.at(cp, (bidx[ok], idx[ok]), w_power[ok])
        return cp

    def system_power(self, p_dyn: np.ndarray, cp_power: np.ndarray) -> np.ndarray:
        """(B, T) true full-system power from the batched dynamic-power
        contraction (``einsum('btm,m->bt', act, dyn_power_w)``)."""
        return self.idle_w[:, None] + self._compress(p_dyn) + cp_power

    def chip_power(self, p_cpu: np.ndarray, cp_power: np.ndarray) -> np.ndarray:
        """(B, T) true chip power (RAPL-like view) from the batched CPU-share
        contraction.  Rows of chipless nodes are still physical truth — the
        simulator simply never *senses* them."""
        return self.chip_idle_w[:, None] + self._compress(p_cpu) + cp_power

    def cp_cpu_fraction(self, cp_power: np.ndarray) -> np.ndarray:
        """(B, T) control-plane CPU utilization fraction (Eq. 2)."""
        dyn = np.maximum(cp_power - 0.0, 0.0)
        return np.clip(dyn / self.cp_cpu_capacity_w[:, None], 0.0, 1.0)

    def sys_cpu_fraction(
        self, p_cpu: np.ndarray, cp_power: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        """(B, T) system-wide CPU utilization proxy.  The per-node busy peak
        is taken over each node's own ``lengths[i]`` valid bins (rows are
        zero-padded to the fleet max), mirroring the per-node fix: empty
        rows peak at 0 and a non-positive capacity falls back to 1 W."""
        busy = p_cpu + cp_power                                   # (B, T)
        lens = np.asarray(lengths, np.int64)
        col = np.arange(busy.shape[1])[None, :]
        masked = np.where(col < lens[:, None], busy, -np.inf)
        peak = np.where(lens > 0, np.max(masked, axis=1), 0.0)
        cap = self.cp_cpu_capacity_w + peak
        cap = np.where(cap <= 0.0, 1.0, cap)
        return np.clip(busy / cap[:, None], 1e-3, 1.0)
