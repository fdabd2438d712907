"""SlotFleetSession: slot-based live fleet serving.

A fixed pool of engine slots — one ``(capacity, M)``-shaped streaming state
— where live nodes claim and release slots while the stream keeps ticking.
Everything that changes at serving time is data, never shape: occupancy
rides ``FleetStep.valid``, a claim rewrites one slot's rows in place
(``fleet_stream_reset_slots``), and an admission's init block is solved at
a length bucket's shape (``bucketed_initial_estimate``).

The reference's churn gate counts jit retraces after ``warmup()``.  The
port has no jit cache, so its stand-in is three checks (ROADMAP Queue 3):
the pool's ``buffer_pointers`` do not move from ``warmup()`` to the end of
a churn trace, no CUDA source is built after ``warmup()``
(``kernels.build.built``), and ``step``, ``admit`` and ``release`` never
make the host wait on the card (they run under
``torch.cuda.set_sync_debug_mode("error")``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core.sessions.base import FleetSession
from repro_torch.device import DEFAULT_DEVICE, resolve_device, stage
from repro_torch.distributed.sharding import reshard as _reshard


class SlotFleetSession(FleetSession):
    """Slot-based live fleet serving session.

    A pool of ``capacity`` engine slots.  A free slot is a permanently
    invalid node: zero rows, frozen Kalman state, exactly-zero attribution.
    ``admit`` claims the lowest free slot and scrubs it in place (the
    rejoin fix: rows a previous tenant wrote earlier in the current partial
    step never reach the new tenant's first boundary update); ``release``
    is host bookkeeping only; ``step`` feeds one telemetry tick.

    Mesh elasticity: the pool state may be split over a ``FleetMesh``
    (``capacity`` must tile it), and ``reshard`` moves the *live* state to
    another mesh mid-stream (checkpoint to host, place again), pinned at
    1e-5 of scale against an uninterrupted run.

    The telemetry-level counterpart is ``StreamingFleetSession(slots=...)``
    / ``EnergyFirstControlPlane.profile_fleet(slots=...)``, which route a
    whole profiling segment through a pool like this one.
    """

    def __init__(
        self,
        capacity: int,
        num_fns: int,
        *,
        step_windows: int,
        config=None,
        mesh=None,
        buckets=None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """Args:
          capacity: number of engine slots B.
          num_fns: per-slot function-axis width M (M_aug with a principal).
          step_windows: ticks per Kalman step (the ring buffer's length).
          config: ``engine.EngineConfig`` (the default config if None).
          mesh: optional ``FleetMesh``; capacity must tile it evenly.  The
            pool's home device is then the mesh's first device.
          buckets: the init solves' length-bucket table
            (``engine.DEFAULT_BUCKETS`` if None).
          device: where the pool runs without a mesh (default the card).
        """
        super().__init__(config=eng.EngineConfig() if config is None else config, mesh=mesh)
        self.capacity = int(capacity)
        self.num_fns = int(num_fns)
        self.step_windows = int(step_windows)
        self.buckets = tuple(eng.DEFAULT_BUCKETS if buckets is None else buckets)
        if mesh is not None:
            mesh.validate(self.capacity)
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)
        self._state = eng.fleet_stream_init(
            torch.zeros((self.capacity, self.num_fns)), self.step_windows,
            mesh=mesh, device=self.device,
        )
        self._slot_node: list = [-1] * self.capacity   # slot -> node (-1 free)
        self._node_slot: dict = {}                     # node -> slot
        # One host block per tick: c | a | lat_sum | lat_sumsq (capacity x
        # M each), then w and valid (capacity each).
        cap, m = self.capacity, self.num_fns
        self._host = np.zeros(cap * (4 * m + 2), np.float32)
        self._host_views = self._carve(self._host)
        self.admits = 0
        self.releases = 0

    def _carve(self, flat):
        """(c, a, lat_sum, lat_sumsq, w, valid) views of one flat block."""
        cap, m = self.capacity, self.num_fns
        rows = [flat[i * cap * m : (i + 1) * cap * m].reshape(cap, m) for i in range(4)]
        base = 4 * cap * m
        return (*rows, flat[base : base + cap], flat[base + cap : base + 2 * cap])

    # -- pool state --------------------------------------------------------

    @property
    def state(self):
        """Live engine state (capacity-shaped ``FleetStreamState``; a
        ``Shards`` tuple of them on a mesh)."""
        return self._state

    @property
    def ticks(self) -> int:
        """Ticks the pool has advanced."""
        return self.ticks_dispatched

    @property
    def free_slots(self) -> int:
        """Number of unclaimed slots."""
        return self._slot_node.count(-1)

    @property
    def live_nodes(self) -> tuple:
        """Nodes currently holding slots, in slot order."""
        return tuple(n for n in self._slot_node if n != -1)

    def slot_of(self, node) -> int:
        """Slot index currently held by ``node`` (raises if none)."""
        try:
            return self._node_slot[node]
        except KeyError:
            raise ValueError(f"node {node!r} holds no slot") from None

    def estimates(self) -> dict:
        """``node -> (M,)`` current Kalman power estimate for live nodes
        (numpy; reads the card)."""
        x = self.engine_x().cpu().numpy()
        return {node: x[slot] for node, slot in self._node_slot.items()}

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> dict[str, int]:
        """Run every serving code path once at the pool's shapes.

        Every bucket's init solve (``warm_bucket_solvers``), one whole Kalman
        step of ``fleet_step`` and one slot reset on a scratch state (the
        live state never advances), then a wait for the card.  Returns the
        live state's ``buffer_pointers``: from here to the end of any churn
        trace they must not move (until ``reshard``)."""
        cap, m = self.capacity, self.num_fns
        zeros = lambda *shape: torch.zeros(shape, device=self.device)  # noqa: E731
        eng.warm_bucket_solvers(m, self.config, buckets=self.buckets, device=self.device)
        scratch = eng.fleet_stream_init(
            zeros(cap, m), self.step_windows, mesh=self.mesh, device=self.device
        )
        step = eng.FleetStep(
            c=zeros(cap, m), w=zeros(cap), a=zeros(cap, m),
            lat_sum=zeros(cap, m), lat_sumsq=zeros(cap, m), valid=zeros(cap),
        )
        for _ in range(self.step_windows):
            scratch, _ = eng.fleet_step(scratch, step, self.config, mesh=self.mesh)
        eng.fleet_stream_reset_slots(scratch, zeros(cap), zeros(cap, m), mesh=self.mesh)
        stage(torch.from_numpy(self._host), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return self.buffer_pointers()

    def admit(self, node, init_c=None, init_w=None, *, x0=None) -> int:
        """Claim the lowest free slot for ``node``; returns the slot index.

        Pass either the node's init block (``init_c`` (n, M) contribution
        rows and ``init_w`` (n,) idle-adjusted power, solved to an X_0 row at
        its bucket's shape on the pool's device) or an explicit ``x0`` (M,)
        row (a warm handoff).  The slot's Kalman row is re-initialized and
        its ring-buffer rows and partial-step accumulators zeroed, in place
        (``fleet_stream_reset_slots``).  X_0 never leaves the device, and a
        host ``x0`` crosses without blocking.  Raises ``ValueError`` when
        the node already holds a slot or the pool is full (queue admissions
        with ``serving.scheduler.SlotAdmissionQueue``).
        """
        if node in self._node_slot:
            raise ValueError(f"node {node!r} already holds slot {self._node_slot[node]}")
        try:
            slot = self._slot_node.index(-1)
        except ValueError:
            raise ValueError(
                f"slot pool full (capacity {self.capacity}); release a node first"
            ) from None
        if x0 is None:
            if init_c is None or init_w is None:
                raise ValueError("admit needs either x0= or an (init_c, init_w) block")
            x0 = eng.bucketed_initial_estimate(
                init_c, init_w, self.config, buckets=self.buckets, device=self.device
            )
        elif not (isinstance(x0, torch.Tensor) and x0.device == self.device):
            x0 = stage(torch.as_tensor(x0, dtype=torch.float32).cpu(), self.device)
        # Written through views: a Python scalar stored into a CUDA tensor
        # by index would cross from the host and synchronize.
        x0_full = torch.zeros((self.capacity, self.num_fns), device=self.device)
        x0_full[slot].copy_(x0)
        flags = torch.zeros((self.capacity,), device=self.device)
        flags[slot].fill_(1.0)
        self._state = eng.fleet_stream_reset_slots(self._state, flags, x0_full, mesh=self.mesh)
        self._slot_node[slot] = node
        self._node_slot[node] = slot
        self.admits += 1
        return slot

    def release(self, node) -> int:
        """Release ``node``'s slot back to the pool; returns the slot index.

        Host bookkeeping only: from the next tick the slot is absent from
        the feeds (``valid = 0``), so its Kalman row freezes and its
        attribution is exactly zero until a new tenant claims, and thereby
        scrubs, the slot."""
        slot = self._node_slot.pop(node, None)
        if slot is None:
            raise ValueError(f"node {node!r} holds no slot")
        self._slot_node[slot] = -1
        self.releases += 1
        return slot

    def step(self, feeds: dict):
        """Advance the pool one telemetry tick; returns ``TickAttribution``.

        ``feeds`` maps ``node -> (c, w, a, lat_sum, lat_sumsq)`` per-tick
        rows ((M,), scalar, (M,), (M,), (M,)) for the nodes that produced
        this window.  A live node absent from ``feeds`` dropped the window
        (``valid = 0`` for this tick only); free slots are always invalid.
        The rows fill one host block of capacity rows, which crosses to the
        card in one non-blocking copy from pinned memory.  The attribution
        is slot-major (capacity rows): map it back with ``slot_of``.  Raises
        ``ValueError`` on a feed for a node holding no slot."""
        self._host.fill(0.0)
        c, a, ls, lq, w, valid = self._host_views
        for node, (c_i, w_i, a_i, ls_i, lq_i) in feeds.items():
            slot = self._node_slot.get(node)
            if slot is None:
                raise ValueError(f"feed for node {node!r} which holds no slot")
            c[slot] = c_i
            w[slot] = w_i
            a[slot] = a_i
            ls[slot] = ls_i
            lq[slot] = lq_i
            valid[slot] = 1.0
        c, a, ls, lq, w, valid = self._carve(stage(torch.from_numpy(self._host), self.device))
        return self.advance(
            eng.FleetStep(c=c, w=w, a=a, lat_sum=ls, lat_sumsq=lq, valid=valid)
        )

    def advance(self, step):
        """Advance the pool one tick with a slot-major ``FleetStep`` already
        on the pool's device (``valid`` flags free slots 0); returns the
        slot-major ``TickAttribution``.  ``step`` builds such a tick from
        host feeds; ``StreamingFleetSession(slots=...)`` scatters its
        device rows into one."""
        self._state, att = eng.fleet_step(self._state, step, self.config, mesh=self.mesh)
        self.ticks_dispatched += 1
        return att

    def reshard(self, mesh) -> None:
        """Move the live pool onto another device mesh mid-stream.

        Checkpoint to host and place again (``distributed.sharding.
        reshard``); the values keep their bits.  ``mesh=None`` places the
        pool whole on its home device.  The pool's buffers move, so take a
        new ``buffer_pointers`` snapshot after a reshard."""
        if mesh is not None:
            mesh.validate(self.capacity)
        self._state = _reshard(self._state, mesh, device=self.device)
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.devices[0]
