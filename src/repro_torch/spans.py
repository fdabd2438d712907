"""Host spans: named intervals of the program's own work, for a profiler
trace to read.

``span(name)`` opens a ``torch.profiler`` record function of that name
around a block.  Each is a host-only span: it goes into a
``torch.profiler`` trace beside the operators it encloses, on the same
clock as the device's events, and puts no interval of its own on the
device's timeline (it is not a user annotation, as
``torch.profiler.record_function`` is).  With no profiler running a span
costs one object and its two calls, and keeps nothing.

Names are dotted and lower case -- ``serve.*`` for the serving engine's
calls, ``model.*`` for the model's parts, ``train.*`` for the train step's
phases -- and never hold ``::``, which marks an operator's name in a
trace.  A span is opened only in the program's Python, never inside a
custom op's body (``kernels/``).
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast


def span(name: str) -> _RecordFunctionFast:
    """A context manager that records ``name`` around its block while a
    profiler runs."""
    return _RecordFunctionFast(name)
