"""granite-3-8b — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155, SwiGLU, tied-free.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    mlp="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="granite-3-8b-smoke",
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
