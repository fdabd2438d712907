"""Kernels (``csrc/flash_attention_bwd.cu``): the roofline bound of
``repro_torch::flash_attention_bwd`` (its five products, 2.5 times the
forward's) over the device time of what it launched, as a percent."""

from bench import readers


def read(window):
    return readers.flash(window, ("repro_torch::flash_attention_bwd",))
