"""Model step (``models/common.py::apply_rope``): the device milliseconds an
invocation of the operations launched under the span ``model.rope``, the
rotary embedding of q and k in every layer: the sines and cosines, the
rotation in fp32 and the casts."""

from bench import spans


def read(window):
    return spans.ms_per_unit(window, "model.rope")
