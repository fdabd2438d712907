"""Launchers of the port: ``serve`` (the model-zoo serving path, metered)."""
