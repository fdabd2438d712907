"""Serving engine (``serving/engine.py::ServeEngine.prefill``): the device
operations (kernels, copies, sets) an invocation launched under the span
``serve.prefill``, the whole call's."""

from bench import spans


def read(window):
    return spans.count_per_unit(window, "serve.prefill")
