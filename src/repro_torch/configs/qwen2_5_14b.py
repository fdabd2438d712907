"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    mlp="swiglu",
    qkv_bias=True,
    rope_theta=1.0e6,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="qwen2.5-14b-smoke",
    num_layers=2,
    d_model=80,
    num_heads=5,
    num_kv_heads=1,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    vocab_pad_multiple=64,
    remat="none",
)
