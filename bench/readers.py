"""What the per-layer readers share: a roofline share over named operators,
the model-FLOP share of the peak, and the device's idle share.  Each
returns None where the trace holds no device operation to read (a run on
the CPU) or the card has no row in ``costs.PEAKS``: a share is never
reported as 0 for want of data."""

from __future__ import annotations

from bench import costs

#: The matrix-product operators; a product is counted at the innermost one,
#: the operator its kernels were launched under.
PRODUCTS = frozenset({"aten::mm", "aten::addmm", "aten::bmm"})


def roofline(window, names, work) -> float | None:
    """Percent: the least time of the slice's calls of the operators named
    in ``names`` (its units times one unit's, ``work(op)`` giving FLOPs,
    bytes and dtype from an operator's recorded shapes) over the device
    time of the operations they launched in the slice.  An operator whose
    work its shapes do not give adds no work (the share reads low, never
    high)."""
    peaks = window.cell["peaks"]
    if not peaks or not window.device:
        return None
    bound = 0.0
    for op in window.unit_ops:
        if op.name in names:
            got = work(op)
            if got is not None:
                bound += costs.bound_seconds(*got, peaks)
    busy = window.device_time(names)
    return 100.0 * window.units * bound / busy if busy > 0 and bound > 0 else None


def products(window) -> float | None:
    return roofline(window, PRODUCTS, lambda op: costs.product_work(op.name, op.shapes, op.dtypes))


def flash(window, names) -> float | None:
    """``roofline`` of the flash attention ops; ``causal`` is the op's last
    argument, as the profiler recorded its value."""
    def work(op):
        causal = op.inputs[-1] if op.inputs else None
        if not isinstance(causal, bool):
            return None
        return costs.flash_work(op.name, op.shapes, op.dtypes, causal)

    return roofline(window, frozenset(names), work)


def mfu(window) -> float | None:
    """Percent of the compute peak of the configuration's dtype that the
    model FLOPs of the untraced window's units a second make."""
    peaks = window.cell["peaks"]
    if not peaks or not window.device:
        return None
    return 100.0 * window.rate * window.cell["unit_flops"] / peaks[window.cell["compute"]]


def idle(window) -> float | None:
    """Percent of the untraced window with no device operation running:
    one less the slice's busy seconds a unit times the window's units a
    second."""
    if not window.device:
        return None
    return 100.0 * (1.0 - window.busy_per_unit * window.rate)
