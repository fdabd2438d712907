"""repro_torch: FaasMeter (Energy-First Serverless Computing) in PyTorch/CUDA.

The PyTorch twin of the JAX package ``repro``, mirroring its subpackage
layout so every ported module has an obvious reference to be tested
against:

- ``repro_torch.workload``  -- Azure-trace-style FaaS workload generation
  (numpy, bitwise twin of the reference).
- ``repro_torch.telemetry`` -- simulated power sensors (numpy); telemetry
  leaves the host as float32 CPU tensors.
- ``repro_torch.core``      -- contribution matrices, clock sync, NNLS
  disaggregation, the Kalman filter, Shapley footprints, the fleet segment
  engine and the profiler.
- ``repro_torch.kernels``   -- hand-written CUDA kernels for Hopper (sm_90a)
  with their plain PyTorch versions.
- ``repro_torch.models``, ``serving``, ``training`` -- the model zoo, its
  metered serving path and its training path (optimizer, train step,
  trainer); ``distributed`` the logical-axis sharding rules, the fleet
  mesh, the collectives and the checkpoints; ``launch`` the launchers, their
  meshes and the analytic step cost.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asks for ``device="cpu"``; see ``device.py``.
"""

from repro_torch.version import __version__

__all__ = ["__version__"]
