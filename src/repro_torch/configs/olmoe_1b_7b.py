"""olmoe-1b-7b — MoE, 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) vocab=50304, expert d_ff=1024, no shared
experts.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    mlp="swiglu",
    num_experts=64,
    num_shared_experts=0,
    top_k=8,
    expert_d_ff=1024,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="olmoe-1b-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    vocab_pad_multiple=64,
    num_experts=8,
    top_k=2,
    expert_d_ff=32,
    remat="none",
)
