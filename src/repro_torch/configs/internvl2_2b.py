"""internvl2-2b — VLM: InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The ViT frontend is a
STUB per the assignment: ``input_specs()`` delivers precomputed patch
embeddings (B, frontend_tokens, frontend_dim); the model owns the
projector (frontend_dim -> d_model) and the LM backbone.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    mlp="swiglu",
    frontend_tokens=256,    # 256 patch embeddings per image (448px, pixel-shuffle)
    frontend_dim=1024,      # InternViT-300M width
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="internvl2-2b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vocab_pad_multiple=64,
    frontend_tokens=8,
    frontend_dim=32,
    remat="none",
)
