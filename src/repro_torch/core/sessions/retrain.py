"""Live model maintenance for streaming sessions (paper §4.3 / §5).

``RetrainMixin`` carries the continuous-retraining surface of
``StreamingFleetSession``: scoring each node's counter model at Kalman-step
boundaries, the fleet-batched sliding-window refit, and the periodic skew
re-estimate.  It is a mixin, not a base — the methods operate on the
session's own buffers (``_win_feats``, ``_raw_chip``, ``_models``, ...) and
live in a separate module only so the dispatch/emit pipeline in
``streaming.py`` stays readable on its own.

Everything here runs in the emit stage (or in a hook), on the host: the
window features and the raw chip rows are host data, and the session keeps
a host copy of its counter models, so scoring and refitting read nothing
from the card.  A refit writes the new rows into the session's model and
``x_cpu`` tensors in place, so no carried tensor moves.  Under a drained
ingest a hook calling ``refit_counter_models`` or ``resync`` races only on
*when* the dispatching thread observes the change — bounded by the drain
queue's depth in ticks — never on torn state (the dispatch stage reads
neither the models nor ``x_cpu``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cpu_model as cpumod
from repro_torch.core import sync as syncmod
from repro_torch.core.sessions.combined import combined_chip_power


class RetrainMixin:
    """Continuous retraining + resync methods shared into the streaming session."""

    def _window_rows(self, lo: int, hi: int):
        """Host (B, hi-lo, F) window features and (B, hi-lo) raw chip power."""
        feats = torch.from_numpy(np.ascontiguousarray(self._win_feats[:, lo:hi]))
        chip = torch.from_numpy(np.stack(self._raw_chip[lo:hi], axis=1))
        return feats, chip

    def _check_retrain(self, t: int) -> None:
        """Paper §4.3 continuous retraining, live: at the Kalman-step
        boundary closing at tick ``t``, score each node's counter model on
        the step's (window features, observed chip power) pairs through
        ``cpu_model.model_error`` / ``retrain_flags`` (the one place the
        criterion is defined), on the host.  Dead (ragged) nodes score only
        their real windows; a node with none stays un-flagged."""
        lo, hi = t - self.cfg.step_windows + 1, t + 1
        feats, chip = self._window_rows(lo, hi)
        live = torch.from_numpy(np.arange(lo, hi)[None, :] < self._n_nodes[:, None])
        err = cpumod.model_error(self._models_host, feats, chip, mask=live)
        self.model_errors.append(err.numpy())
        # Chipless nodes have no counter model to retrain: never flagged.
        flags = cpumod.retrain_flags(self._models_host, feats, chip, self._retrain_cfg, mask=live)
        self.retrain_needed = flags.numpy() & self._chip_mask

    def refit_counter_models(self, flags, *, window_steps: int = 2, lam: float = 1e-4) -> np.ndarray:
        """Re-fit flagged nodes' counter models on a sliding window, live.

        The paper's continuous-retraining loop (§4.3), closed: when
        ``retrain_needed`` fires at a Kalman-step boundary, the caller (the
        ``ControlLoop``, or any ``on_tick`` hook) invokes this with the
        flags.  All flagged nodes are re-fit in **one** fleet-batched
        ``cpu_model.fit_ridge`` over the trailing ``window_steps`` Kalman
        steps of (window features, observed chip power) pairs — dead ragged
        windows mask-weighted out — on the host, and merged row-wise
        (``cpu_model.merge_models``) into the session's model tensors in
        place.  The live chip split (``x_cpu``) is recomputed under the
        updated models, in place too, so later ticks and the finalized
        reports see the new attribution.  Returns the (B,) bool mask of
        nodes actually re-fit (flags on nodes with no live window in range
        are dropped).
        """
        if not self.combined or self._win_feats is None:
            raise ValueError(
                "refit_counter_models needs combined mode with "
                "window_features (see prepare_combined_fleet)"
            )
        flags = np.asarray(flags, bool).reshape(self.b) & self._chip_mask
        hi = min(self._next_tick, self._n_raw, self._win_feats.shape[1])
        lo = max(hi - window_steps * self.cfg.step_windows, 0)
        live = np.arange(lo, hi)[None, :] < self._n_nodes[:, None]
        flags = flags & live.any(axis=1)
        if not flags.any() or hi <= lo:
            return np.zeros(self.b, bool)
        feats, chip = self._window_rows(lo, hi)
        new = cpumod.fit_ridge(feats, chip, lam, mask=torch.from_numpy(live.astype(np.float32)))
        merged = cpumod.merge_models(self._models_host, new, torch.from_numpy(flags))
        for host, dev, value in zip(self._models_host, self._models, merged):
            host.copy_(value)
            dev.copy_(value)
        x_cpu, resid = combined_chip_power(
            self._models, self._fnc, self._busy, self._durations_dev
        )
        self.x_cpu.copy_(x_cpu)
        self._x_cpu_resid.copy_(resid)
        self._force_chipless_zero()
        self.retrain_needed = self.retrain_needed & ~flags
        self.refits.append((hi, flags))
        return flags

    def resync(self, window: int | None = None) -> np.ndarray:
        """Re-estimate per-node sensor skew over the trailing raw windows.

        The bootstrap estimates skew once on the init segment; clocks drift,
        so the control loop periodically re-estimates over the last
        ``window`` raw windows (default: the init-block length), on the
        host.  Causality clamp: updated skews are clipped to the bootstrap
        lookahead, so every already-buffered tick still has the raw windows
        its interpolation needs.  Appends to ``skew_history`` and returns
        the updated (B,) skews.
        """
        if self.skews is None:
            raise ValueError("resync needs the bootstrap skew estimate first")
        if not self.has_chip:
            return self.skews
        hi = self._n_raw
        lo = max(hi - (window if window is not None else self.init_n), 0)
        if hi - lo < 4:  # too few windows for a meaningful lag estimate
            return self.skews
        w_arr = self._raw_w[lo:hi]
        r_arr = np.stack(self._raw_chip[lo:hi])
        col = lambda a, i: torch.from_numpy(np.ascontiguousarray(a[:, i]))
        new = np.asarray(
            [
                float(syncmod.estimate_skew(col(w_arr, i), col(r_arr, i), max_shift=self.cfg.sync_max_shift))
                if self._chip_mask[i]
                else 0.0
                for i in range(self.b)
            ]
        )
        self.skews = np.minimum(new, float(self._lookahead))
        self.skew_history.append((hi, self.skews.copy()))
        return self.skews
