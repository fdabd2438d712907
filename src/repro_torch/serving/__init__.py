"""Serving runtime of the port: the model-zoo serve engine, KV-cache
accounting, the metered server, the energy-aware scheduler, and the
energy-first control plane with its live streaming footprint trackers and
the closed control loop (``ControlLoop``).

Top of the layer stack: these modules may import anything below them — the
profiler orchestration, the session layer, the engine stages — but nothing
below may import them back.  ``ServeEngine`` (model-zoo batching) is not
re-exported here: it pulls the model zoo in at import time.  The slot-pool
admission queue waits for ROADMAP Queue 1 item 8.
"""

from repro_torch.serving.control_plane import (
    CapRunResult,
    ControlConfig,
    ControlLoop,
    EnergyFirstControlPlane,
    MeteredServer,
    ProfiledWorkload,
    StreamingFootprintTracker,
)
from repro_torch.serving.scheduler import (
    EnergyAwareScheduler,
    Invocation,
    KeepAliveCache,
    SchedulerConfig,
    SchedulerStats,
    energy_aware_placement,
)

__all__ = [
    "CapRunResult",
    "ControlConfig",
    "ControlLoop",
    "EnergyAwareScheduler",
    "EnergyFirstControlPlane",
    "Invocation",
    "KeepAliveCache",
    "MeteredServer",
    "ProfiledWorkload",
    "SchedulerConfig",
    "SchedulerStats",
    "StreamingFootprintTracker",
    "energy_aware_placement",
]
