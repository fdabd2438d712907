"""Live session layer between ``core.engine`` and ``core.profiler``.

Everything here owns mutable host-side state — telemetry buffers,
background ingest/drain threads — and drives the engine one call at a
time.  The ``FaasMeterProfiler`` a session needs is received duck-typed,
never imported.

- ``base``      — ``FleetSession``: engine config plumbing and the stream
                  diagnostics (ticks dispatched, carried buffer storage).
- ``report``    — ``FootprintReport`` and the shared finalizer (steps 5-6)
                  every profiling path ends in.
- ``combined``  — §4.3 chip-side helpers (``combined_chip_power``,
                  ``prepare_combined_fleet``).
- ``drain``     — ``StreamTick`` + the background emit worker of a drained
                  ingest.
- ``retrain``   — continuous retraining / resync mixin (§4.3 live loop).
- ``streaming`` — ``StreamingFleetSession``: window-by-window profiling in
                  pure or combined mode, with prefetched ingest and an
                  optional drain thread.

Not yet ported (see ROADMAP.md): the slot-pool session (Queue 1 item 8).
"""

from repro_torch.core.sessions.base import FleetSession
from repro_torch.core.sessions.combined import combined_chip_power, prepare_combined_fleet
from repro_torch.core.sessions.drain import StreamTick, _DrainWorker
from repro_torch.core.sessions.report import (
    FootprintReport,
    _finalize_report,
    _node_durations,
    _per_fn_latency_stats,
    finalize_streaming_session,
)
from repro_torch.core.sessions.streaming import StreamingFleetSession

__all__ = [
    "FleetSession",
    "FootprintReport",
    "combined_chip_power",
    "prepare_combined_fleet",
    "StreamTick",
    "StreamingFleetSession",
]
