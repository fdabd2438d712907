"""Kernels (``kernels/flash_attention.py`` -> ``csrc/flash_attention_tc.cu``):
the roofline bound of ``repro_torch::flash_attention`` over the device time
of what it launched, as a percent."""

from bench import readers


def read(window):
    return readers.flash(window, ("repro_torch::flash_attention", "repro_torch::flash_attention_lse"))
