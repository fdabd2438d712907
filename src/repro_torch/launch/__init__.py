"""Launchers of the port: ``serve`` (the model-zoo serving path, metered)
and ``train`` (a training run with checkpoints and resume)."""
