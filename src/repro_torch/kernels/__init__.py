"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``disagg_solve`` -- CUDA ``disagg_gram`` (``csrc/disagg_gram.cu``), the
  gram assembly of the fleet engine, plus its NNLS/ridge solve wrappers.
- ``ops``          -- device dispatch: kernel on CUDA, plain version on CPU.
- ``ref``          -- the plain versions.

Kernels are built at first use, never at import.
"""
