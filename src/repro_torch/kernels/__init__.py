"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``disagg_solve``     -- CUDA ``disagg_gram`` (``csrc/disagg_gram.cu``), the
  gram assembly of the fleet engine (a warp per batch entry at M <= 16, a
  register-tiled SYRK otherwise), plus its NNLS/ridge solve wrappers.
- ``flash_attention``  -- CUDA forward GQA attention for prefill: the
  tensor-core kernel for bf16 at d in {64, 112, 128}
  (``csrc/flash_attention_tc.cu``), the FMA kernel for the rest
  (``csrc/flash_attention.cu``); and its backward for the training path
  (``csrc/flash_attention_bwd.cu``: a rowsum prologue, a dK/dV pass and a
  dQ pass, both on ``wgmma`` fed by TMA rings in bf16 at d in {64, 112, 128},
  FMAs otherwise); ``csrc/hopper.cuh`` holds the mbarrier, TMA and wgmma
  helpers the forward's and the backward's tensor-core kernels share.
- ``decode_attention`` -- CUDA single-token attention against a KV cache
  (``csrc/decode_attention.cu``: one launch, a cp.async K/V ring, the
  cache's slices merged inside a thread-block cluster).
- ``rmsnorm``          -- CUDA fused RMSNorm (``csrc/rmsnorm.cu``).
- ``build``            -- the one ``nvcc`` + ``ctypes`` build and load path.
- ``ops``              -- device dispatch: kernel on CUDA, plain version on CPU.
- ``ref``              -- the plain versions.

Kernels are built at first use, never at import.
"""

#: Every kernel source under ``csrc/``, in the order ``chip_smoke.py`` lists them.
KERNELS = ("disagg_gram", "flash_attention", "flash_attention_tc", "flash_attention_bwd", "decode_attention",
           "rmsnorm")
