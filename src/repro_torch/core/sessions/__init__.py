"""Session layer between ``core.engine`` and ``core.profiler``.

- ``report`` — ``FootprintReport`` and the shared finalizer (steps 5-6)
  every profiling path ends in.

The live streaming, slot-serving, drain and combined-mode sessions are not
ported yet (see ROADMAP.md).
"""

from repro_torch.core.sessions.report import (
    FootprintReport,
    _finalize_report,
    _node_durations,
    _per_fn_latency_stats,
)

__all__ = ["FootprintReport"]
