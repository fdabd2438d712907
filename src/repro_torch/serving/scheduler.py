"""Energy-aware FaaS scheduler: queueing, keep-alive, power-capped admission.

The scheduler is the control-plane component FaasMeter §5 instruments:

- **Queue + admission**: invocations queue per function class; the head of
  the queue is admitted iff the power cap allows it, using the function's
  FaasMeter footprint J_lambda as the predicted energy increment
  (``core.capping.PowerCapController``).  Without a footprint, the static
  buffer fallback applies — the paper's comparison.
- **Keep-alive**: warm engines (params + compiled executables + resident
  caches) are retained greedy-dual style (cost = cold-start latency x
  frequency / residency bytes); eviction -> next invocation is a cold start.
- **Straggler mitigation**: invocations exceeding ``timeout_factor`` x the
  class's mean latency are cancelled and requeued (bounded retries), and the
  node is flagged — the serving-side analogue of the trainer watchdog.

- **Slot admission**: ``SlotAdmissionQueue`` queues nodes joining a full
  ``SlotFleetSession`` pool and admits them in arrival order as slots free.

A copy of the reference's module (plain Python and NumPy).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Any, Callable

import numpy as np

from repro_torch.core.capping import CappingConfig, FleetPowerCapController, PowerCapController


@dataclasses.dataclass
class Invocation:
    function: str
    arrival: float
    payload: Any = None
    retries: int = 0
    admitted_at: float | None = None
    started_at: float | None = None
    finished_at: float | None = None

    @property
    def queue_wait(self) -> float:
        return (self.started_at or self.arrival) - self.arrival


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    capping: CappingConfig = CappingConfig()
    keep_alive_bytes: int = 8 << 30      # residency budget for warm engines
    timeout_factor: float = 5.0          # straggler cutoff vs class mean
    max_retries: int = 2


@dataclasses.dataclass
class _WarmEntry:
    engine: Any
    bytes: int
    freq: float = 0.0
    cold_cost_s: float = 0.0
    credit: float = 0.0  # greedy-dual credit


class KeepAliveCache:
    """Greedy-dual keep-alive (paper [40], FaasCache) over warm engines."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.entries: dict[str, _WarmEntry] = {}
        self._clock = 0.0

    def get(self, fn: str) -> Any | None:
        e = self.entries.get(fn)
        if e is None:
            return None
        e.freq += 1.0
        e.credit = self._clock + e.cold_cost_s * e.freq / max(e.bytes, 1)
        return e.engine

    def put(self, fn: str, engine: Any, nbytes: int, cold_cost_s: float) -> list[str]:
        """Insert a warm engine; returns the list of evicted functions.

        Re-putting a resident function replaces its entry in place: its old
        bytes are released *before* the budget check (so they are never
        double-counted against itself) and it can never be chosen as its own
        eviction victim; its access frequency carries over.  A budget that
        lands exactly exhausted (used + nbytes == budget) admits without
        evicting — the greedy-dual rule only fires strictly past the budget.
        """
        evicted = []
        prev = self.entries.pop(fn, None)
        used = sum(e.bytes for e in self.entries.values())
        while self.entries and used + nbytes > self.budget:
            victim = min(self.entries, key=lambda k: self.entries[k].credit)
            self._clock = self.entries[victim].credit  # greedy-dual aging
            used -= self.entries[victim].bytes
            del self.entries[victim]
            evicted.append(victim)
        e = _WarmEntry(
            engine=engine, bytes=nbytes, cold_cost_s=cold_cost_s,
            freq=(prev.freq + 1.0) if prev is not None else 1.0,
        )
        e.credit = self._clock + cold_cost_s * e.freq / max(nbytes, 1)
        self.entries[fn] = e
        return evicted

    @property
    def resident(self) -> set[str]:
        return set(self.entries)


def energy_aware_placement(
    fleet: FleetPowerCapController,
    footprint_joules: float | None,
    duration_s: float | None = None,
    *,
    live=None,
) -> int | None:
    """GreenFaaS-style energy-aware placement over a capped fleet.

    Candidate nodes are tried in descending cap headroom (the node with the
    most watts to spare under its guarded cap first); the first node whose
    admission rule accepts wins and is charged (``admit`` — stats plus the
    optimistic power accounting), losers are only probed (``would_admit``,
    no side effects).  Returns the winning node index, or None when no live
    node can take the invocation this control interval (the caller defers
    it).  ``live`` (B,) bool restricts candidates to still-streaming nodes.
    """
    order = np.argsort(-fleet.headroom_watts(), kind="stable")
    for i in order:
        i = int(i)
        if live is not None and not live[i]:
            continue
        if fleet.would_admit(i, footprint_joules, duration_s):
            fleet.admit(i, footprint_joules, duration_s)
            return i
    return None


@dataclasses.dataclass
class SchedulerStats:
    completed: int = 0
    cold_starts: int = 0
    requeued: int = 0
    deferred_by_cap: int = 0
    queue_waits: list = dataclasses.field(default_factory=list)
    latencies: list = dataclasses.field(default_factory=list)


class EnergyAwareScheduler:
    """Single-node scheduler driving the simulated/real execution substrate.

    ``executor(inv) -> latency_s`` performs the invocation;
    ``footprint_of(fn) -> J | None`` supplies FaasMeter footprints.
    """

    def __init__(
        self,
        config: SchedulerConfig,
        executor: Callable[[Invocation], float],
        footprint_of: Callable[[str], float | None],
        *,
        mean_latency_of: Callable[[str], float] | None = None,
    ):
        self.config = config
        self.executor = executor
        self.footprint_of = footprint_of
        self.mean_latency_of = mean_latency_of or (lambda fn: 1.0)
        self.cap = PowerCapController(config.capping)
        self.queue: deque[Invocation] = deque()
        self.stats = SchedulerStats()
        self._lat_acc: dict[str, list[float]] = defaultdict(list)

    def submit(self, inv: Invocation) -> None:
        self.queue.append(inv)

    def observe_power(self, watts: float) -> None:
        self.cap.observe_power(watts)

    def drain(self, now: float = 0.0) -> int:
        """Admit + run queued invocations while the power cap allows."""
        ran = 0
        while self.queue:
            inv = self.queue[0]
            if not self.cap.admit(self.footprint_of(inv.function)):
                self.stats.deferred_by_cap += 1
                break
            self.queue.popleft()
            inv.admitted_at = now
            inv.started_at = now
            latency = self.executor(inv)
            mean = self.mean_latency_of(inv.function)
            if latency > self.config.timeout_factor * mean and inv.retries < self.config.max_retries:
                inv.retries += 1
                self.stats.requeued += 1
                self.queue.append(inv)  # straggler: retry at the tail
                continue
            inv.finished_at = now + latency
            self.stats.completed += 1
            self.stats.queue_waits.append(inv.queue_wait)
            self.stats.latencies.append(latency)
            self._lat_acc[inv.function].append(latency)
            ran += 1
        return ran

    def drain_fleet(
        self,
        now: float,
        *,
        fleet: FleetPowerCapController,
        placement: bool = True,
        live=None,
    ) -> list[tuple[Invocation, int]]:
        """Admit + place queued invocations across a capped fleet.

        The fleet twin of ``drain``: the head of the queue is placed via
        ``energy_aware_placement`` (descending cap headroom, first node whose
        footprint-aware rule admits) and *not executed here* — the caller
        (the streaming ``ControlLoop``) re-injects placed invocations into
        the simulator, which is where their power shows up.  Head-of-line
        blocking is deliberate: when no node can take the head this control
        interval, everything behind it waits too (FIFO fairness, same as the
        single-node path).  With ``placement=False`` each invocation may
        only run on its origin node (``inv.payload["node"]``) — the
        no-migration baseline.  Returns ``[(invocation, node), ...]`` for
        the invocations admitted at ``now``.
        """
        placed = []
        while self.queue:
            inv = self.queue[0]
            j = self.footprint_of(inv.function)
            dur = self.mean_latency_of(inv.function)
            if placement:
                node = energy_aware_placement(fleet, j, dur, live=live)
            else:
                node = inv.payload["node"] if isinstance(inv.payload, dict) else 0
                if live is not None and not live[node]:
                    node = None
                elif not fleet.admit(node, j, dur):
                    node = None
            if node is None:
                self.stats.deferred_by_cap += 1
                break
            self.queue.popleft()
            inv.admitted_at = now
            # An invocation admitted in the same control window it arrived
            # keeps its arrival time (no wait); a deferred one starts at the
            # admitting window.
            inv.started_at = max(now, inv.arrival)
            self.stats.completed += 1
            self.stats.queue_waits.append(inv.queue_wait)
            placed.append((inv, node))
        return placed


@dataclasses.dataclass
class SlotRequest:
    """One node waiting for a slot in a ``SlotFleetSession`` pool.

    Carries everything ``SlotFleetSession.admit`` needs: the node id plus
    either a warm-start estimate (``x0``) or the raw init-block windows
    (``init_c``/``init_w``) from which the pool runs a bucketed init solve.
    """

    node: int
    init_c: Any = None
    init_w: Any = None
    x0: Any = None


class SlotAdmissionQueue:
    """FIFO admission control feeding a ``SlotFleetSession`` slot pool.

    The serving analogue of ``KeepAliveCache``: joins that arrive while the
    pool is full wait here in arrival order instead of raising, and every
    ``drain()`` (typically once per control interval, after retirements have
    released slots) admits waiting nodes head-first while capacity and the
    optional admission ``gate`` allow.  The gate is the capacity-aware
    admission hook — e.g. ``lambda req: fleet.headroom_watts().max() > 0``
    defers joins when no capped node has watts to spare.

    Head-of-line blocking is deliberate and matches ``EnergyAwareScheduler``:
    admission order is arrival order, so a gated head request parks the
    whole queue until the gate clears.
    """

    def __init__(self, pool, *, gate: Callable[[SlotRequest], bool] | None = None):
        self.pool = pool
        self.gate = gate
        self._queue: deque[SlotRequest] = deque()
        self.admitted: list[int] = []
        self.deferred = 0

    @property
    def pending(self) -> int:
        """Number of joins still waiting for a slot."""
        return len(self._queue)

    def submit(self, node: int, init_c=None, init_w=None, *, x0=None) -> int | None:
        """Enqueue a join; admit immediately when a slot is free.

        Returns the slot index when the node was admitted on the spot, or
        None when it was queued (pool full, earlier joins waiting, or the
        gate deferred it).
        """
        self._queue.append(SlotRequest(node, init_c, init_w, x0))
        admitted = self.drain()
        for n, slot in admitted:
            if n == node:
                return slot
        return None

    def drain(self) -> list[tuple[int, int]]:
        """Admit queued joins in FIFO order while slots and the gate allow.

        Returns ``[(node, slot), ...]`` for every admission made this call.
        """
        placed: list[tuple[int, int]] = []
        while self._queue and self.pool.free_slots > 0:
            req = self._queue[0]
            if self.gate is not None and not self.gate(req):
                self.deferred += 1
                break
            slot = self.pool.admit(
                req.node, req.init_c, req.init_w, x0=req.x0
            )
            self._queue.popleft()
            self.admitted.append(req.node)
            placed.append((req.node, slot))
        return placed
