"""Train step (``training/train_step.py``): 6 N D plus three times the
forward's causal attention over the untraced window's steps, as a percent
of the card's bf16 peak (the train driver's ``unit_flops``; recomputation
not counted)."""

from bench import readers


def read(window):
    return readers.mfu(window)
