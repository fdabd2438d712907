"""The plain reference the benchmark holds the port to: plain PyTorch in
fp32 with TF32 off.  It imports nothing of the port, of ``repro`` or of JAX,
and takes only what the benchmark made: weights and tokens."""
