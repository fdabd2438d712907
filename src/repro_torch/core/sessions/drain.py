"""The emit stage of a streaming session: tick records + the drain worker.

``StreamTick`` is the per-tick record every streaming hook consumes;
``_DrainWorker`` is the background thread that materializes and emits those
records when a session runs a *drained* ingest
(``StreamingFleetSession.ingest(drain=True)``) — the third pipeline stage
after ingest (prefetch thread) and dispatch (caller thread).  The worker
never touches engine state: it only calls back into the owning session's
``_emit_tick``, so dispatch order — and therefore every numeric — is
identical with and without it.  A copy of the reference's module (threading
and numpy only).
"""

from __future__ import annotations

import queue
import threading
from typing import NamedTuple

import numpy as np


class StreamTick(NamedTuple):
    """Per-tick record handed to streaming hooks (numpy, ready to consume).

    Emitted by ``StreamingFleetSession`` for every engine tick (window index
    ``init_n <= t < init_n + s * step_windows``).  All arrays are (B, ...) —
    node-major — and ``tick_power.sum(-1) + unattributed == target`` holds
    per tick (conserved causal attribution).
    """

    t: int                      # window index of this tick
    x: np.ndarray               # (B, M_aug) live per-function power estimate (W)
    tick_power: np.ndarray      # (B, M_aug) conserved per-tick attribution (W)
    unattributed: np.ndarray    # (B,) power in ticks with no activity (W)
    busy_seconds: np.ndarray    # (B, M_aug) per-function runtime in this tick (s)
    a: np.ndarray               # (B, M_aug) invocations starting in this tick
    target: np.ndarray          # (B,) idle-adjusted power fed to the engine (W)
    w_sys: np.ndarray           # (B,) synchronized system power (W)
    step_completed: bool        # did this tick close a Kalman step
    valid: np.ndarray | None = None  # (B,) bool: node still streaming at t
                                     # (None on a uniform fleet = all live)


class _DrainWorker:
    """Background emit stage of a drained ingest (``ingest(drain=True)``).

    Owns a bounded queue of dispatched-but-unemitted ticks and a daemon
    thread that materializes each one (``StreamingFleetSession._emit_tick``:
    device→numpy transfer, ``on_tick``).  An exception in a hook is
    captured, stops further emits, and re-raises on the dispatching thread
    at the next ``put`` (or at ``close``).  ``close(abandon=True)`` discards
    pending emits and still joins the thread — the no-deadlock shutdown
    contract.
    """

    _SENTINEL = object()

    def __init__(self, session, depth: int = 8):
        self._session = session
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(
            target=self._run, name="session-drain", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            if self._stop.is_set():
                continue  # abandoned: keep draining, emit nothing
            try:
                self._session._emit_tick(*item)
            except BaseException as e:  # noqa: BLE001 - re-raised on dispatch
                self._errors.append(e)
                self._stop.set()

    def put(self, item) -> None:
        """Enqueue one dispatched tick; re-raises a prior emit failure."""
        if self._errors:
            raise self._errors[0]
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue
        if self._errors:
            raise self._errors[0]

    def close(self, *, abandon: bool = False) -> None:
        """Flush (or discard) pending emits and join the drain thread.

        ``abandon=False`` waits for every queued tick to emit, then
        re-raises the first hook exception if one occurred.  ``abandon=True``
        (mid-stream shutdown, another exception already propagating) skips
        pending emits — dropping queued items if the queue is full so the
        sentinel always lands — and never raises.
        """
        if abandon:
            self._stop.set()
            while True:
                try:
                    self._q.put_nowait(self._SENTINEL)
                    break
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass
        else:
            self._q.put(self._SENTINEL)
        self._thread.join()
        if not abandon and self._errors:
            raise self._errors[0]
