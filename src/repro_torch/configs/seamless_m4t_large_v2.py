"""seamless-m4t-large-v2 — audio encoder-decoder [arXiv:2308.11596; hf].

24L encoder + 24L decoder, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The speech frontend is a STUB per the assignment: ``input_specs()`` delivers
precomputed frame embeddings (B, frames, frontend_dim); the encoder consumes
them directly.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    mlp="swiglu",
    frontend_dim=1024,       # w2v-BERT 2.0 feature width (stubbed)
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="seamless-m4t-large-v2-smoke",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_multiple=64,
    frontend_dim=32,
    remat="none",
)
