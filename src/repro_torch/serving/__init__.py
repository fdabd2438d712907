"""Serving runtime of the port: the model-zoo serve engine, KV-cache
accounting and the metered server.  The energy-first control plane, the
scheduler and the control loop wait for ROADMAP Queue 1 items 5-7."""

from repro_torch.serving.control_plane import MeteredServer

__all__ = ["MeteredServer"]
