"""Model step (``models/common.py::rms_norm``): the device milliseconds an
invocation of the operations launched under the span ``model.norm``, every
RMSNorm of the prefill (two a layer and the final one): the fp32 upcast,
the mean of squares, the reciprocal root, the gain and the cast back."""

from bench import spans


def read(window):
    return spans.ms_per_unit(window, "model.norm")
