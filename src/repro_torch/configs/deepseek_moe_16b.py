"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16) vocab=102400; 64 routed experts top-6 +
2 shared experts, expert d_ff=1408; layer 0 uses a dense FFN (d_ff=
num_experts/4 * expert_d_ff = 10944 in the release; we use 16*1408).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8 * 1408,           # dense layer-0 FFN width
    vocab_size=102400,
    mlp="swiglu",
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    first_dense=True,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="deepseek-moe-16b-smoke",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_multiple=64,
    num_experts=8,
    num_shared_experts=2,
    top_k=2,
    expert_d_ff=32,
    remat="none",
)
