"""Kernels: the cuBLAS products of the prefill (under ``aten::mm`` and its
kin), their roofline bound over their device time, as a percent."""

from bench import readers


def read(window):
    return readers.products(window)
