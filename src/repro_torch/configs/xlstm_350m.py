"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H vocab=50304, d_ff=0 (blocks carry their own expansion).
Even layers are mLSTM (matrix memory, parallel form), odd layers sLSTM
(scalar memory, recurrent scan), 1:1 alternation.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=2,
)

REDUCED = dataclasses.replace(
    CONFIG,
    name="xlstm-350m-smoke",
    num_layers=2,
    d_model=64,
    num_heads=2,
    head_dim=32,
    vocab_size=256,
    vocab_pad_multiple=64,
    remat="none",
)
