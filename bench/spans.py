"""What the readers of the port's own spans share: the device operations
launched under a span of a given name.

The port opens host spans in its own code (``src/repro_torch/spans.py``):
``serve.*`` around the serving engine's calls, ``model.*`` around the
model's parts, ``train.*`` around the train step's phases.  They are host
operations of the traced slice like any other, with a name that holds no
``::``, so ``tracing.HostOp.operator`` passes over them and the kernel
metrics' tie of a kernel to its operator is unchanged.  A device operation
belongs to a span when the span encloses the operator that launched it
(``DeviceOp.op``) on that operator's own thread (``HostOp.parent``).

Each reader returns None where the slice holds no device operation (a run
on the CPU) or no span of its name (a program that opens none).
"""

from __future__ import annotations


def launched_under(window, name: str) -> list | None:
    """The slice's device operations launched under a span ``name``, or
    None where the slice holds no device operation or no such span."""
    if not window.device or not any(op.name == name for op in window.ops):
        return None
    memo: dict = {}

    def inside(op) -> bool:
        path = []
        while op is not None and id(op) not in memo:
            if op.name == name:
                memo[id(op)] = True
                break
            path.append(op)
            op = op.parent
        got = op is not None and memo[id(op)]
        for o in path:
            memo[id(o)] = got
        return got

    return [d for d in window.device if d.op is not None and inside(d.op)]


def ms_per_unit(window, name: str) -> float | None:
    """Milliseconds of device time a unit (an invocation or a step) of the
    operations launched under ``name``."""
    ops = launched_under(window, name)
    if ops is None:
        return None
    return 1e-6 * sum(d.end - d.start for d in ops) / window.units


def count_per_unit(window, name: str) -> float | None:
    """Device operations (kernels, copies, sets) a unit launched under
    ``name``."""
    ops = launched_under(window, name)
    return None if ops is None else len(ops) / window.units
