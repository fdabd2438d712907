"""Launchers of the port: ``serve`` (the model-zoo serving path, metered)
and ``train`` (a training run placed on a mesh, with checkpoints and
resume); ``mesh`` builds their meshes and holds the H100's constants,
``costs`` is the analytic step cost."""
