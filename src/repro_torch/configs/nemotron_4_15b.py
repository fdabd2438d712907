"""nemotron-4-15b — dense GQA, squared-ReLU MLP [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp="sq_relu",
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="nemotron-4-15b-smoke",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    vocab_pad_multiple=64,
    remat="none",
)
