"""Training: AdamW with clipping and a warmup-cosine schedule
(``optimizer``), the train step (``train_step``) and the fault-tolerant
step loop (``trainer``) -- the twins of the reference's
``repro/training``."""
