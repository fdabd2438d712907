"""StreamingFleetSession: telemetry in window-by-window, state out live.

The paper's operating mode — footprints as a control-plane operation.  The
session is a small pipeline over the streaming engine
(``core.engine.streaming``):

  ingest stage   ``push_window``/``ingest`` buffer raw fleet telemetry
                 (optionally prefetched on a background thread);
  dispatch stage ``_process_tick`` builds each tick's feed and dispatches
                 one ``fleet_step``, appending the (device) trajectory in
                 order — it never waits on the card;
  emit stage     ``_emit_tick`` materializes the tick's attribution to
                 numpy and invokes ``on_tick`` — inline by default, or on a
                 background *drain thread* (``ingest(drain=True)``).

Dispatch order is identical with and without the drain thread, so the
numerics are bitwise the same.  Both threads enqueue on the device's
default stream (a thread that sets no stream uses it), so a tick's
device→host copy on the drain thread follows that tick's kernels in stream
order; the attribution tensors it reads are fresh, never views of the
state that later ticks overwrite.

What the trace fixes up front — contribution rows, per-window invocation
counts and latency moments (with the control-plane principal's column) —
is computed on the host, where float sums are taken in a fixed order (CUDA
``index_add_`` adds floats atomically, in a run-dependent order), and moved
to the device once in ``__init__``.  Per tick, only the synchronized power
row, in combined mode (§4.3) the raw chip row, and the principal's
contribution cross to the device, in one non-blocking copy from pinned
memory.  Combined mode's chip side (``x_cpu``) is static per segment until
a live refit (``core.sessions.retrain``) rewrites it in place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import contribution as contrib
from repro_torch.core import cpu_model as cpumod
from repro_torch.core import sync as syncmod
from repro_torch.core.engine.plan import segment_plan
from repro_torch.core.sessions.base import FleetSession
from repro_torch.core.sessions.combined import (
    _as_fleet_counters,
    _as_fleet_model,
    combined_chip_power,
)
from repro_torch.core.sessions.drain import StreamTick, _DrainWorker
from repro_torch.core.sessions.report import (
    FootprintReport,
    _node_durations,
    _per_fn_latency_stats,
    _trace_tensors,
    finalize_streaming_session,
)
from repro_torch.core.sessions.retrain import RetrainMixin
from repro_torch.core.sessions.slots import SlotFleetSession
from repro_torch.device import DEFAULT_DEVICE, resolve_device, stage

Tensor = torch.Tensor


def _host_trace(arrays):
    """A node's (fn_id, start, end) as CPU tensors; the trace is host data."""
    if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in arrays):
        raise ValueError(
            "StreamingFleetSession takes the invocation traces as host arrays "
            "(numpy or CPU tensors): their statistics are computed on the host"
        )
    return _trace_tensors(*arrays, torch.device("cpu"))


def _host(t: Tensor) -> np.ndarray:
    """A tensor as a numpy array the caller owns (never a view of session
    buffers)."""
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


class StreamingFleetSession(RetrainMixin, FleetSession):
    """Online fleet profiling: telemetry in window-by-window, state out live.

    Callers push one delta-window of fleet telemetry at a time
    (``push_window``); the session bootstraps on the init segment (skew
    estimate + X_0, §4.2/§5), then advances the streaming engine
    (``engine.fleet_step``) one call per tick, invoking ``on_tick`` with
    live conserved attribution.  ``finalize`` produces the same
    ``FootprintReport`` list as the segment paths, through the shared
    ``_finalize_report``.

    Synchronization: with a chip reference, per-node skew is estimated once
    over the init segment (the batch profiler estimates over the full
    segment — a documented difference) and applied causally: tick ``t`` is
    dispatched once raw window ``t + ceil(max(skew, 0))`` has arrived.
    Tail windows are flushed with the batch path's edge clamp at
    ``finalize``.

    Combined mode (§4.3): the engine disaggregates the chip-subtracted
    'rest' power, ``combined_rest_target(w, chip, rest_idle)`` per tick,
    with the rest-side idle estimated from the chip floor over the init
    block; the chip side ``x_cpu`` comes from the per-node counter models
    (``combined_chip_power``).  With ``window_features`` each node's model
    is scored at every Kalman-step boundary (``retrain_needed``,
    ``model_errors``), and ``refit_counter_models`` / ``resync`` maintain
    the models and skews live (``RetrainMixin``).

    Restrictions (those of ``fleet_profile_batched``): default NNLS/no_idle
    disaggregation, equal num_fns across nodes, every node covering the
    common init window, and at least one node with a full Kalman step after
    it.  Durations may differ per node (a *ragged* fleet): nodes whose
    stream ends mid-segment stop feeding the engine (``FleetStep.valid``)
    and finalize against their own window count.  ``has_chip`` may be per
    node: chipless rows are zeroed on ingest, their skew is 0, and in
    combined mode their target is exactly the pure one.
    """

    def __init__(
        self,
        profiler,
        traces: list[tuple],
        *,
        num_fns: int,
        duration: float | Sequence[float],
        idle_watts,
        has_chip,
        has_cp: bool,
        on_tick=None,
        on_bootstrap=None,
        mesh=None,
        slots: int | None = None,
        fn_counters=None,
        counter_model=None,
        window_features=None,
        retrain_config: cpumod.CpuModelConfig = cpumod.CpuModelConfig(),
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """Args:
          profiler: configured ``FaasMeterProfiler`` (pure or combined mode).
          traces: per-node (fn_id, start, end) invocation arrays (numpy or
            CPU tensors).
          num_fns: number of unique functions M.
          duration: segment length in seconds — one float, or a per-node
            sequence for a ragged fleet.
          idle_watts: (B,) static idle power per node.
          has_chip: whether ``push_window`` carries a chip reference (skew
            estimation) — one bool or a per-node sequence.
          has_cp: whether ``push_window`` carries control-plane/system CPU
            fractions (appends the shared principal column, §4.1).
          on_tick: ``callable(StreamTick)`` invoked per engine tick.
          on_bootstrap: ``callable(session)`` invoked once after X_0.
          fn_counters: (B, M, F) normalized per-function counters (combined
            mode; see ``prepare_combined_fleet``).
          counter_model: fleet-batched / per-node-list / shared
            ``LinearPowerModel`` (combined mode).
          window_features: optional (B, N, F) per-window counter features
            (host data) — enables the retrain checks at step boundaries.
          retrain_config: thresholds for those checks.
          mesh: optional ``distributed.sharding.FleetMesh``: the engine
            state is split over its devices (B, or the slot capacity with
            ``slots``, must tile it) and the session's tensors live on its
            first device, which replaces ``device``.
          slots: optional slot-pool capacity >= B: the engine runs on a
            ``SlotFleetSession`` of this many slots.  Nodes claim slots at
            bootstrap (a warm handoff of their X_0 rows) and release them
            when their streams end; spare slots stay free and invalid.
          device: where the engine runs (default the card).
        """
        cfg = profiler.config
        if cfg.mode not in ("pure", "combined"):
            raise ValueError(f"unknown profiler mode {cfg.mode!r}")
        if not cfg.disagg.nonneg or cfg.disagg.mode != "no_idle":
            raise ValueError(
                "StreamingFleetSession supports the default NNLS/no_idle "
                "disaggregation config only"
            )
        super().__init__(config=None, mesh=mesh)
        dev = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.device = dev
        self.cfg = cfg
        self.num_fns = num_fns
        self.b = len(traces)
        self.durations, self._ragged = _node_durations(duration, self.b)
        self._slots_cap = None if slots is None else int(slots)
        if self._slots_cap is not None and self._slots_cap < self.b:
            raise ValueError(f"slots={slots} is smaller than the fleet (B={self.b})")
        if mesh is not None:
            mesh.validate(self.b if self._slots_cap is None else self._slots_cap)
        self._slot_pool: SlotFleetSession | None = None
        self._slot_rows: Tensor | None = None  # node i -> its pool slot (device)
        self._slot_valid: Tensor | None = None  # (B,) ones: a dense fleet's liveness
        if np.ndim(has_chip) == 0:
            self._chip_mask = np.full(self.b, bool(has_chip))
        else:
            self._chip_mask = np.asarray(has_chip, bool).reshape(-1)
            if self._chip_mask.shape[0] != self.b:
                raise ValueError(
                    f"has_chip sequence has {self._chip_mask.shape[0]} "
                    f"entries for {self.b} node(s)"
                )
        # Chipless rows are forced to exactly 0.0 on ingest.
        self._chip_zero = self._chip_mask.astype(np.float32)
        self.has_chip = bool(self._chip_mask.any())
        self.combined = cfg.mode == "combined"
        if self.combined:
            if not self.has_chip:
                raise ValueError(
                    "combined mode needs a chip reference on at least one node (has_chip)"
                )
            if fn_counters is None or counter_model is None:
                raise ValueError(
                    "combined mode needs fn_counters and counter_model "
                    "(see prepare_combined_fleet)"
                )
        self.has_cp = has_cp
        self.on_tick = on_tick
        self.on_bootstrap = on_bootstrap

        plans = [segment_plan(cfg, d) for d in self.durations]
        self.s_nodes = [p[2] for p in plans]
        self.n_windows = max(p[0] for p in plans)
        self.init_n = plans[0][1]
        self.s = max(self.s_nodes)
        self.n_used = self.init_n + self.s * cfg.step_windows
        if any(p[1] != self.init_n for p in plans):
            raise ValueError(
                "ragged fleet: every node must cover the common N_init "
                f"window ({cfg.init_windows} windows); got per-node init "
                f"blocks {[p[1] for p in plans]} (use the per-node path)"
            )
        if self.s == 0:
            raise ValueError(
                "segment too short for a Kalman step; use the per-node path"
            )
        # Per-node engine span: the last tick node i really feeds.
        self._n_used_nodes = np.asarray(
            [self.init_n + s_i * cfg.step_windows for s_i in self.s_nodes]
        )
        # Per-node real window counts: the sync edge clamp stops at each
        # node's OWN last real window.
        self._n_nodes = np.asarray([p[0] for p in plans], np.float64)
        self.m_aug = num_fns + (1 if has_cp else 0)
        self.idle_watts = np.asarray(idle_watts, np.float32).reshape(self.b)
        self._idle = torch.as_tensor(self.idle_watts, device=dev)
        self.init_seconds = self.init_n * cfg.delta

        # Static per-node precomputation on the host (the trace is known;
        # telemetry is what streams), moved to the device once.
        n_post = self.s * cfg.step_windows
        c_nodes, a_nodes, ls_nodes, lq_nodes = [], [], [], []
        counts_nodes, lat_nodes, init_a = [], [], []
        for arrays in traces:
            fn_id, start, end = _host_trace(arrays)
            c_nodes.append(
                contrib.contribution_matrix(
                    fn_id, start, end, num_fns=num_fns,
                    num_windows=self.n_windows, delta=cfg.delta,
                )
            )
            a_w, ls_w, lq_w = profiler._per_step_stats(
                fn_id, start, end, num_fns, num_fns, self.init_n, n_post,
                step_windows=1,
            )
            a_nodes.append(a_w)
            ls_nodes.append(ls_w)
            lq_nodes.append(lq_w)
            counts, mean_lat, _, _ = _per_fn_latency_stats(fn_id, start, end, num_fns)
            counts_nodes.append(counts)
            lat_nodes.append(mean_lat)
            valid = (fn_id >= 0) & (start >= 0) & (start < self.init_seconds)
            seg = torch.where(valid, torch.clamp(fn_id, 0, num_fns - 1), num_fns)
            a0 = torch.zeros(num_fns + 1).index_add_(0, seg, valid.to(torch.float32))[:num_fns]
            if has_cp:
                a0 = torch.cat([a0, torch.ones(1)])
            init_a.append(a0)
        a_win, ls_win, lq_win = (torch.stack(x) for x in (a_nodes, ls_nodes, lq_nodes))
        if has_cp:
            # The principal's one pseudo-invocation per step, on its first
            # tick, with zero latency.
            first = (torch.arange(n_post) % cfg.step_windows == 0).to(torch.float32)
            first = first[None, :, None].expand(self.b, n_post, 1)
            a_win = torch.cat([a_win, first], dim=2)
            ls_win = torch.cat([ls_win, torch.zeros_like(first)], dim=2)
            lq_win = torch.cat([lq_win, torch.zeros_like(first)], dim=2)
        self._c_fns = torch.stack(c_nodes).to(dev)             # (B, N, M)
        self._a_win = a_win.to(dev)                            # (B, n_post, M_aug)
        self._ls_win = ls_win.to(dev)
        self._lq_win = lq_win.to(dev)
        self._busy = torch.stack(c_nodes).sum(dim=1).to(dev)   # (B, M) seconds
        self.counts = torch.stack(counts_nodes).to(dev)        # (B, M)
        self.mean_latency = torch.stack(lat_nodes).to(dev)
        self.init_invocations = torch.stack(init_a).to(dev)    # (B, M_aug)
        # Ragged fleets: per-tick node liveness, host (for hooks) and device.
        self._live = None
        if self._ragged:
            ticks = self.init_n + np.arange(n_post)
            self._live = ticks[:, None] < self._n_used_nodes[None, :]   # (n_post, B)
            self._live_dev = torch.as_tensor(self._live, dtype=torch.float32, device=dev)

        self.config = self._engine_cfg = self.eng.EngineConfig(
            kalman=cfg.kalman, delta=cfg.delta,
            init_iters=cfg.disagg.nnls_iters,
            init_ridge_lambda=cfg.disagg.ridge_lambda,
        )

        # Combined mode (§4.3): the chip-side split is static per segment
        # (the trace — hence busy seconds and counters — is known up front;
        # only the power telemetry streams), so X_CPU is computed once here
        # and exposed for live consumers.  The models live on the device and,
        # for the emit stage's retrain checks, in a host copy; a refit
        # rewrites both, and ``x_cpu``, in place.
        self.x_cpu: Tensor | None = None
        self._x_cpu_resid: Tensor | None = None
        self._models: cpumod.LinearPowerModel | None = None
        self._models_host: cpumod.LinearPowerModel | None = None
        self._win_feats: np.ndarray | None = None
        self._retrain_cfg = retrain_config
        self.model_errors: list[np.ndarray] = []
        self.retrain_needed = np.zeros(self.b, bool)
        self.refits: list[tuple[int, np.ndarray]] = []       # (window, flags)
        self.skew_history: list[tuple[int, np.ndarray]] = []  # (window, skews)
        self._fnc: Tensor | None = None
        self._durations_dev = torch.as_tensor(self.durations, dtype=torch.float32, device=dev)
        if self.combined:
            self._models = _as_fleet_model(counter_model, self.b, dev)
            self._models_host = cpumod.LinearPowerModel(*(x.cpu().clone() for x in self._models))
            self._fnc = _as_fleet_counters(fn_counters, self.b, num_fns, dev)
            self.x_cpu, self._x_cpu_resid = combined_chip_power(
                self._models, self._fnc, self._busy, self._durations_dev
            )
            self._force_chipless_zero()
            if window_features is not None:
                self._win_feats = torch.as_tensor(window_features, dtype=torch.float32).cpu().numpy()
        self._rest_idle_nodes: np.ndarray | None = None    # (B,) set at bootstrap
        self._rest_idle_dev: Tensor | None = None

        # Streaming state.
        self._raw_w = np.zeros((self.n_windows, self.b), np.float32)
        self._n_raw = 0                          # pushed system windows
        self._raw_chip: list[np.ndarray] = []
        self._cp_col: list[np.ndarray] = []      # per-window principal column
        self._w_sync: list[np.ndarray] = []      # synchronized windows, in order
        self.skews: np.ndarray | None = None     # (B,) estimated at init_n
        self._lookahead = 0
        self.booted = False
        self.x0: Tensor | None = None
        self.init_busy_seconds: Tensor | None = None
        self._state = None
        self._traj: list[Tensor] = []
        self._next_tick = self.init_n
        self._drain: _DrainWorker | None = None

    @property
    def state(self):
        """Live engine state (``FleetStreamState``; the pool's, slot-major,
        with ``slots``; a ``Shards`` tuple on a mesh)."""
        return self._slot_pool.state if self._slot_pool is not None else self._state

    def final_x(self) -> Tensor:
        """(B, M_aug) current estimate in node order, a fresh tensor on the
        session's device (gathered from the pool's slots with ``slots``)."""
        if self._slot_pool is not None:
            return self._slot_pool.engine_x().index_select(0, self._slot_rows)
        return self.engine_x()

    # -- ingestion ---------------------------------------------------------

    def push_window(
        self,
        w_sys: np.ndarray,
        w_chip: np.ndarray | None = None,
        cp_frac: np.ndarray | None = None,
        sys_frac: np.ndarray | None = None,
    ) -> None:
        """Feed one delta-window of fleet telemetry (all shapes (B,)).

        Windows must arrive in order.  May trigger zero or more engine
        ticks (``on_tick``) depending on the sync lookahead; the bootstrap
        (skew + X_0 + ``on_bootstrap``) fires once the init segment and its
        lookahead are buffered.
        """
        if self._n_raw >= self.n_windows:
            raise ValueError("segment already fully pushed")
        if self.has_chip and w_chip is None:
            raise ValueError("session was created with has_chip=True")
        if self.has_cp and (cp_frac is None or sys_frac is None):
            raise ValueError("session was created with has_cp=True")
        self._raw_w[self._n_raw] = np.asarray(w_sys, np.float32).reshape(self.b)
        self._n_raw += 1
        if self.has_chip:
            self._raw_chip.append(
                np.asarray(w_chip, np.float32).reshape(self.b) * self._chip_zero
            )
        if self.has_cp:
            # Eq. 2's principal column (``contribution.
            # shared_principal_contribution``) on the host: telemetry stays
            # numpy until the tick's one copy to the device.
            cp = np.asarray(cp_frac, np.float32).reshape(self.b)
            sf = np.asarray(sys_frac, np.float32).reshape(self.b)
            ratio = cp / np.maximum(sf, np.float32(1e-6))
            self._cp_col.append(np.clip(ratio, 0.0, 1.0) * np.float32(self.cfg.delta))
        self._advance()

    def ingest(self, ticks, *, prefetch: int = 2, drain: bool = False) -> None:
        """Feed a whole telemetry tick stream, prefetched ahead of the engine.

        ``ticks`` is any iterator of objects with ``w_sys`` / ``w_chip`` /
        ``cp_frac`` / ``sys_frac`` attributes (``simulator.FleetTelemetryTick``
        in practice).  With ``prefetch >= 1`` the stream is pulled on a
        background thread (``data.pipeline.prefetch_iterator``), so the
        host-side work that produces tick ``t + 1`` overlaps the dispatch of
        tick ``t``; ``prefetch = 0`` is strict alternation.

        With ``drain=True`` the emit stage (device→numpy, ``on_tick``) moves
        to a background *drain thread* as well.  Dispatch order is
        unchanged, so results are bitwise identical; hook exceptions
        re-raise here, and on any failure both background threads are
        joined before this call returns.
        """
        if self._drain is not None:
            raise ValueError("a drained ingest is already running on this session")
        if prefetch > 0:
            from repro_torch.data.pipeline import prefetch_iterator

            ticks = prefetch_iterator(ticks, size=prefetch)
        if drain:
            self._drain = _DrainWorker(self)
        try:
            for tk in ticks:
                self.push_window(tk.w_sys, tk.w_chip, tk.cp_frac, tk.sys_frac)
        except BaseException:
            if self._drain is not None:
                worker, self._drain = self._drain, None
                worker.close(abandon=True)
            close = getattr(ticks, "close", None)
            if close is not None:
                close()
            raise
        else:
            if self._drain is not None:
                worker, self._drain = self._drain, None
                worker.close()

    # -- internals ---------------------------------------------------------

    def _force_chipless_zero(self) -> None:
        """Pin chipless nodes' chip-side split at exactly 0.0, in place.

        Their counter models come out zero from ``prepare_combined_fleet``
        already; this makes the guarantee independent of the caller's
        model (a shared model broadcast over a mixed fleet, say)."""
        cm = torch.as_tensor(self._chip_zero, device=self.x_cpu.device)
        self.x_cpu.mul_(cm[:, None])
        self._x_cpu_resid.mul_(cm)

    def _synced_window(self, t: int) -> np.ndarray:
        """(B,) synchronized system power for window ``t`` (``apply_shift``
        semantics: per-node linear interpolation of ``t + skew``, edges
        clamped to each node's OWN segment, so a short node's positively
        skewed tail zero-order-holds at its last real window; the sync
        lookahead guarantees the needed raw windows have arrived)."""
        n = self._n_nodes  # (B,) per-node real window counts
        pos = np.clip(t + self.skews, 0.0, n - 1.0)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, (n - 1).astype(np.int64))
        frac = (pos - lo).astype(np.float32)
        avail = self._n_raw - 1
        nodes = np.arange(self.b)
        lo_v = self._raw_w[np.minimum(lo, avail), nodes]
        hi_v = self._raw_w[np.minimum(hi, avail), nodes]
        return lo_v * (np.float32(1.0) - frac) + hi_v * frac

    def _advance(self) -> None:
        cfg = self.cfg
        raw_count = self._n_raw
        if self.skews is None and raw_count >= self.init_n:
            if self.has_chip:
                w_arr = self._raw_w[: self.init_n]               # (init_n, B)
                r_arr = np.stack(self._raw_chip[: self.init_n])
                # Chipless nodes have no reference to sync against: skew 0.
                col = lambda a, i: torch.from_numpy(np.ascontiguousarray(a[:, i]))
                self.skews = np.asarray(
                    [
                        float(
                            syncmod.estimate_skew(
                                col(w_arr, i), col(r_arr, i), max_shift=cfg.sync_max_shift
                            )
                        )
                        if self._chip_mask[i]
                        else 0.0
                        for i in range(self.b)
                    ]
                )
            else:
                self.skews = np.zeros(self.b)
            self._lookahead = int(np.ceil(max(float(np.max(self.skews)), 0.0)))
        if self.skews is None:
            return
        if not self.booted:
            if raw_count < min(self.init_n + self._lookahead, self.n_windows):
                return
            self._bootstrap()
        lim = min(self.n_used, self.n_windows)
        while self._next_tick < lim and self._n_raw >= min(
            self._next_tick + self._lookahead + 1, self.n_windows
        ):
            self._process_tick(self._next_tick)
            self._next_tick += 1

    def _bootstrap(self) -> None:
        """Init-segment solve: synchronized windows 0..init_n-1 -> X_0."""
        eng = self.eng
        for t in range(self.init_n):
            self._w_sync.append(self._synced_window(t))
        w_init = torch.as_tensor(np.stack(self._w_sync, axis=1), device=self.device)
        if self.combined:
            # Rest-side idle from the chip floor over the init block — the
            # batch paths' estimator, on the host rows, so the streaming
            # targets are causal and equal to theirs.
            chip_init = torch.from_numpy(np.stack(self._raw_chip[: self.init_n], axis=1))
            rest_idle = eng.fleet_rest_idle(chip_init, torch.from_numpy(self.idle_watts))
            self._rest_idle_nodes = rest_idle.numpy()
            self._rest_idle_dev = rest_idle.to(self.device)
            target = eng.combined_rest_target(
                w_init, chip_init.to(self.device), self._rest_idle_dev[:, None]
            )
        else:
            target = torch.clamp(w_init - self._idle[:, None], min=0.0)  # (B, init_n)
        init_c = self._c_aug_block(0, self.init_n)                  # (B, init_n, M_aug)
        self.x0 = eng.fleet_initial_estimate(init_c, target, self._engine_cfg)
        self.init_busy_seconds = init_c.sum(dim=1)
        if self._slots_cap is not None:
            # Serving mode: the engine state is a slot pool of the requested
            # capacity.  Nodes claim slots in order (a warm handoff of the
            # batched X_0 rows, no re-solve); spare slots stay free.
            pool = SlotFleetSession(
                self._slots_cap, self.m_aug, step_windows=self.cfg.step_windows,
                config=self._engine_cfg, mesh=self.mesh, device=self.device,
            )
            pool.warmup()
            rows = [pool.admit(i, x0=self.x0[i]) for i in range(self.b)]
            self._slot_rows = stage(torch.as_tensor(rows, dtype=torch.int64), self.device)
            self._slot_valid = torch.ones(self.b, device=self.device)
            self._slot_pool = pool
        else:
            self._state = eng.fleet_stream_init(
                self.x0, self.cfg.step_windows, mesh=self.mesh, device=self.device
            )
        self.booted = True
        if self.on_bootstrap is not None:
            self.on_bootstrap(self)

    def _c_aug_block(self, lo: int, hi: int) -> Tensor:
        """(B, hi-lo, M_aug) contribution rows with the principal appended."""
        block = self._c_fns[:, lo:hi]
        if not self.has_cp:
            return block
        col = torch.as_tensor(np.stack(self._cp_col[lo:hi], axis=1), device=self.device)
        return torch.cat([block, col[:, :, None]], dim=2)

    def _process_tick(self, t: int) -> None:
        """Dispatch stage: build tick ``t``'s feed and launch the engine step.

        Never waits on the device: the trace-side rows are device tensors
        since ``__init__``, the tick's host rows (synchronized power, the raw
        chip power in combined mode, the principal's contribution) cross in
        one non-blocking copy, and the Kalman-step boundary is known from
        the tick index alone.  Emission goes through ``_emit_tick`` —
        inline, or queued to the drain thread.
        """
        cfg = self.cfg
        w_sync = self._synced_window(t)
        self._w_sync.append(w_sync)
        j = t - self.init_n
        host_rows = [w_sync]
        if self.combined:
            host_rows.append(self._raw_chip[t])
        if self.has_cp:
            host_rows.append(self._cp_col[t])
        rows = stage(torch.from_numpy(np.stack(host_rows)), self.device)
        w_dev = rows[0]
        c_t = self._c_fns[:, t]
        if self.has_cp:
            c_t = torch.cat([c_t, rows[-1][:, None]], dim=1)
        if self.combined:
            target = self.eng.combined_rest_target(w_dev, rows[1], self._rest_idle_dev)
        else:
            target = torch.clamp(w_dev - self._idle, min=0.0)
        a_t = self._a_win[:, j]
        live = None
        valid = None
        if self._live is not None:
            # Nodes whose stream (or sub-step tail) ended before t are
            # masked out of the engine: zero rows into the ring buffer,
            # frozen Kalman state, exactly-zero attribution.
            live = self._live[j]
            valid = self._live_dev[j]
        step = self.eng.FleetStep(
            c=c_t, w=target, a=a_t, lat_sum=self._ls_win[:, j],
            lat_sumsq=self._lq_win[:, j], valid=valid,
        )
        if self._slot_pool is not None:
            att = self._pool_tick(t, step)
        else:
            self._state, att = self.eng.fleet_step(
                self._state, step, self._engine_cfg, mesh=self.mesh
            )
        self.ticks_dispatched += 1
        completed = (j + 1) % cfg.step_windows == 0
        if completed:
            self._traj.append(att.x)
        if self._drain is not None:
            self._drain.put((t, att, c_t, a_t, target, w_sync, live, completed))
        else:
            self._emit_tick(t, att, c_t, a_t, target, w_sync, live, completed)

    def _pool_tick(self, t: int, step):
        """Drive one engine tick through the slot pool (``slots=`` mode).

        Nodes whose engine span ends at ``t`` release their slots first
        (continuous retirement: the slot returns to the pool, its Kalman row
        freezes).  The nodes' rows are scattered into a slot-major tick on
        the device (a node that has ended has ``valid`` 0, as does every
        free slot), the pool advances, and the slot-major attribution is
        gathered back to node order on the device."""
        pool = self._slot_pool
        if self._ragged:
            for i in np.nonzero(self._n_used_nodes == t)[0]:
                if int(i) in pool._node_slot:
                    pool.release(int(i))
        rows, cap = self._slot_rows, pool.capacity
        valid = self._slot_valid if step.valid is None else step.valid

        def scatter(x):
            return x.new_zeros((cap,) + tuple(x.shape[1:])).index_copy_(0, rows, x)

        att = pool.advance(
            self.eng.FleetStep(
                c=scatter(step.c), w=scatter(step.w), a=scatter(step.a),
                lat_sum=scatter(step.lat_sum), lat_sumsq=scatter(step.lat_sumsq),
                valid=scatter(valid),
            )
        )
        return att._replace(
            tick_power=att.tick_power.index_select(0, rows),
            unattributed=att.unattributed.index_select(0, rows),
            x=att.x.index_select(0, rows),
        )

    def _emit_tick(self, t, att, c_t, a_t, target, w_sync, live, completed) -> None:
        """Emit stage: the live retrain check at step boundaries (on the
        host), then one dispatched tick materialized for ``on_tick``.

        Runs inline on the dispatching thread by default, or on the drain
        thread under ``ingest(drain=True)`` — in either case ticks emit in
        dispatch order.
        """
        if completed and self._win_feats is not None:
            self._check_retrain(t)
        if self.on_tick is not None:
            self.on_tick(
                StreamTick(
                    t=t,
                    x=_host(att.x),
                    tick_power=_host(att.tick_power),
                    unattributed=_host(att.unattributed),
                    busy_seconds=_host(c_t),
                    a=_host(a_t),
                    target=_host(target),
                    w_sys=w_sync,
                    step_completed=completed,
                    valid=live,
                )
            )

    # -- completion --------------------------------------------------------

    def finalize(self) -> list[FootprintReport]:
        """Close the segment and build per-node reports (requires the full
        ``n_windows`` segment to have been pushed)."""
        return finalize_streaming_session(self)
