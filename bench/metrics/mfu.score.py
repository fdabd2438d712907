"""Model step (``models/transformer.py::decoder_prefill``): the prefill's
model FLOPs over the untraced window, as a percent of the card's bf16 peak;
the count is the score driver's ``unit_flops``."""

from bench import readers


def read(window):
    return readers.mfu(window)
