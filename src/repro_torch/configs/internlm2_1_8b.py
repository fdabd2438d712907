"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    mlp="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="internlm2-1.8b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_multiple=64,
    remat="none",
)
