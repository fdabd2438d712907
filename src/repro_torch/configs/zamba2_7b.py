"""zamba2-7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.  A single
shared transformer block (full attention + SwiGLU FFN) is applied every
``attn_every`` Mamba2 blocks with shared weights, per the Zamba2 design.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    mlp="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    attn_every=6,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="zamba2-7b-smoke",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_multiple=64,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    attn_every=2,
    remat="none",
)
