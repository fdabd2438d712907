"""The traced slice: a ``torch.profiler`` trace read into host operations,
device operations and the benchmark's own spans.

The profiler costs the host microseconds for every launch it records
(thousands a training step), which would pace the card, so a traced run
measures its window untraced, as an untraced run does, and then traces a
slice of further units (``SLICE`` of the window's length).  The slice gives
the device's work per unit; the window gives the untraced rate of units
(``Window.rate``).  A share of the untraced window, such as the idle share,
is the slice's device time per unit times that rate.

Each device operation is tied to the host operation that launched it: the
profiler links a kernel to the innermost operation open on the launching
thread (``linked_correlation_id``); where that is one of the profiler's own
markers, the operation that encloses it is taken.

Work is counted from the shapes the profiler records on each operation
(``record_shapes``), so a metric reads the same work whatever kernel
implements it.  Recording shapes costs the host tens of microseconds an
operation more, so they are recorded over one unit (an invocation or a
step) in set-up (``recording``), and the slice is traced without them:
every unit of a cell does the same work, so the slice's work is its units
times the recorded unit's.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

SPAN_PREFIX = "bench::"
WINDOW_SPAN = "bench::window"

#: The traced slice's length, as a share of the window's.
SLICE = 0.25


@contextlib.contextmanager
def traced(enabled: bool, device):
    """Around the traced slice: with ``enabled``, a profiler trace of host
    and device operations, and the slice's span; otherwise nothing.
    Yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=_activities(device)) as prof:
        with record_function(WINDOW_SPAN):
            yield prof


def _activities(device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


@contextlib.contextmanager
def recording(enabled: bool, device):
    """Around one unit in set-up: with ``enabled``, a profiler trace with
    each operation's shapes and scalar arguments (``launching_ops`` reads
    it); otherwise nothing.  Yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import profile

    with profile(activities=_activities(device), record_shapes=True) as prof:
        yield prof


def launching_ops(prof) -> list:
    """The operators of a ``recording`` that launched device operations,
    with their shapes: one unit's work."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ops, by_corr, linked = [], {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith(SPAN_PREFIX):
                linked.append(e.linked_correlation_id())
            continue
        s = e.start_ns()
        op = HostOp(e.name(), s, s + e.duration_ns(), e.start_thread_id(), e.shapes(), e.dtypes(),
                    e.concrete_inputs())
        ops.append(op)
        by_corr[e.correlation_id()] = op
    _parents(ops)
    out: dict = {}
    for corr in linked:
        op = by_corr.get(corr)
        op = op.operator() if op is not None else None
        if op is not None:
            out[id(op)] = op
    return list(out.values())


class HostOp:
    __slots__ = ("name", "start", "end", "tid", "shapes", "dtypes", "inputs", "parent")

    def __init__(self, name, start, end, tid, shapes, dtypes, inputs):
        self.name, self.start, self.end, self.tid = name, start, end, tid
        self.shapes, self.dtypes, self.inputs, self.parent = shapes, dtypes, inputs, None

    def operator(self):
        """The nearest enclosing operator (a name with a namespace, such as
        ``aten::mm``), this one included; None outside any."""
        op = self
        while op is not None and "::" not in op.name:
            op = op.parent
        return op


class DeviceOp:
    __slots__ = ("name", "start", "end", "op")

    def __init__(self, name, start, end, op):
        self.name, self.start, self.end, self.op = name, start, end, op


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _parents(ops: list) -> None:
    """Set each host operation's parent: the innermost one of its thread
    that encloses it."""
    by_tid = defaultdict(list)
    for op in ops:
        by_tid[op.tid].append(op)
    for seq in by_tid.values():
        seq.sort(key=lambda o: (o.start, -o.end))
        stack: list = []
        for op in seq:
            while stack and stack[-1].end <= op.start:
                stack.pop()
            op.parent = stack[-1] if stack else None
            stack.append(op)


class Window:
    """The operations of one traced slice and what the cell did in it.

    ``units`` are the invocations or steps completed in the slice, ``rate``
    the units a second of the untraced window before it, ``unit_ops`` the
    operators one unit launched device work from, with their shapes
    (``launching_ops``), and ``cell`` the cell's facts for the readers: its
    model and traffic files, the device's peaks (None for a card not in
    ``costs.PEAKS``) and the model FLOPs of one unit."""

    def __init__(self, prof, *, units: int, rate: float, unit_ops: list, cell: dict):
        from torch.autograd import DeviceType

        self.units, self.rate, self.unit_ops, self.cell = units, rate, unit_ops, cell
        events = prof.profiler.kineto_results.events()
        host, device = [], []
        for e in events:
            (device if e.device_type() == DeviceType.CUDA else host).append(e)
        win = [e for e in host if e.name() == WINDOW_SPAN]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} '{WINDOW_SPAN}' spans, not one")
        self.start, self.end = win[0].start_ns(), win[0].end_ns()
        t0, t1 = self.start, self.end
        self.ops: list[HostOp] = []
        by_corr: dict = {}
        self.spans: dict = defaultdict(list)
        for e in host:
            s, d = e.start_ns(), e.duration_ns()
            if s + d < t0 or s > t1:
                continue
            op = HostOp(e.name(), s, s + d, e.start_thread_id(), None, None, None)
            self.ops.append(op)
            by_corr[e.correlation_id()] = op
            if op.name.startswith(SPAN_PREFIX):
                self.spans[op.name].append((op.start, op.end))
        _parents(self.ops)
        self.device: list[DeviceOp] = []
        for e in device:
            name = e.name()
            if name.startswith(SPAN_PREFIX):  # the device side of a span, not an operation
                continue
            s = max(e.start_ns(), t0)
            f = min(e.start_ns() + e.duration_ns(), t1)
            if f <= s:
                continue
            op = by_corr.get(e.linked_correlation_id())
            self.device.append(DeviceOp(name, s, f, op.operator() if op is not None else None))
        self.busy = _union((d.start, d.end) for d in self.device)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    @property
    def busy_per_unit(self) -> float:
        """Seconds of one unit in which some device operation ran."""
        return self.busy_s / self.units

    def device_time(self, names) -> float:
        """Seconds of the device operations launched under the operators
        named in ``names``."""
        return sum(d.end - d.start for d in self.device if d.op is not None and d.op.name in names) * 1e-9

    def idle_gaps(self) -> list:
        """(start, end) ns of every stretch of the window with no device
        operation running."""
        gaps, at = [], self.start
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at each gap's middle: the
        innermost operation open there on any thread (the latest to have
        started; the autograd engine runs the backward on a thread of its
        own), or "python" where none is."""
        by_name: dict = defaultdict(float)
        for d in self.device:
            by_name[d.name] += (d.end - d.start) * 1e-9
        gaps = sorted(((a + b) // 2, (b - a) * 1e-9) for a, b in self.idle_gaps())
        best: list = [None] * len(gaps)
        by_tid = defaultdict(list)
        for o in self.ops:
            if o.name != WINDOW_SPAN:
                by_tid[o.tid].append(o)
        for seq in by_tid.values():
            seq.sort(key=lambda o: (o.start, -o.end))
            stack: list = []
            i = 0
            for g, (mid, _) in enumerate(gaps):
                while i < len(seq) and seq[i].start <= mid:
                    while stack and stack[-1].end <= seq[i].start:
                        stack.pop()
                    stack.append(seq[i])
                    i += 1
                while stack and stack[-1].end <= mid:
                    stack.pop()
                if stack and (best[g] is None or stack[-1].start > best[g].start):
                    best[g] = stack[-1]
        idle: dict = defaultdict(float)
        for op, (_, length) in zip(best, gaps):
            idle[op.name if op is not None else "python"] += length
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
