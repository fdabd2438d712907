"""Serving runtime of the port: the model-zoo serve engine, KV-cache
accounting, the metered server, and the energy-first control plane with its
live streaming footprint trackers.  The scheduler and the closed control
loop wait for ROADMAP Queue 1 item 7."""

from repro_torch.serving.control_plane import (
    EnergyFirstControlPlane,
    MeteredServer,
    ProfiledWorkload,
    StreamingFootprintTracker,
)

__all__ = [
    "EnergyFirstControlPlane",
    "MeteredServer",
    "ProfiledWorkload",
    "StreamingFootprintTracker",
]
