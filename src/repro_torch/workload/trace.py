"""Invocation traces: the (fn_id, start, end) triples everything consumes.

A trace T is characterized by its function set S, per-function IAT CDFs, and
duration (paper §5.1).  Marginal-energy ground truth needs *nearly identical*
paired traces T(S) and T(S - f): ``drop_function`` removes one function's
invocations while leaving every other invocation bit-identical, which is
exactly the paper's protocol (the remaining workload is unchanged; only f's
marginal contribution differs).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class InvocationTrace:
    """Flat invocation arrays; fn_id < 0 entries are padding."""

    fn_id: np.ndarray    # (K,) int32
    start: np.ndarray    # (K,) float32 seconds
    end: np.ndarray      # (K,) float32 seconds
    num_fns: int
    duration: float
    fn_names: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.fn_id = np.asarray(self.fn_id, np.int32)
        self.start = np.asarray(self.start, np.float32)
        self.end = np.asarray(self.end, np.float32)

    @property
    def num_invocations(self) -> int:
        return int(np.sum(self.fn_id >= 0))

    def invocations_of(self, fn: int) -> int:
        return int(np.sum(self.fn_id == fn))

    def mean_latency(self) -> np.ndarray:
        """(M,) mean warm latency per function."""
        out = np.zeros(self.num_fns, np.float32)
        for j in range(self.num_fns):
            mask = self.fn_id == j
            if mask.any():
                out[j] = float(np.mean(self.end[mask] - self.start[mask]))
        return out

    def sorted_by_start(self) -> "InvocationTrace":
        order = np.argsort(np.where(self.fn_id >= 0, self.start, np.inf), kind="stable")
        return dataclasses.replace(
            self, fn_id=self.fn_id[order], start=self.start[order], end=self.end[order]
        )


def drop_function(trace: InvocationTrace, fn: int) -> InvocationTrace:
    """T(S - f): identical trace with function ``fn``'s invocations removed
    (marked as padding so array shapes — and jit caches — are preserved)."""
    mask = trace.fn_id == fn
    fn_id = np.where(mask, -1, trace.fn_id).astype(np.int32)
    return dataclasses.replace(trace, fn_id=fn_id)


def concat_traces(a: InvocationTrace, b: InvocationTrace, gap: float = 0.0) -> InvocationTrace:
    """Concatenate b after a (for dynamic active-set workloads, Fig. 8b)."""
    if a.num_fns != b.num_fns:
        raise ValueError("traces must share a function universe")
    shift = a.duration + gap
    return InvocationTrace(
        fn_id=np.concatenate([a.fn_id, b.fn_id]),
        start=np.concatenate([a.start, b.start + shift]),
        end=np.concatenate([a.end, b.end + shift]),
        num_fns=a.num_fns,
        duration=a.duration + gap + b.duration,
        fn_names=a.fn_names,
    )


def pad_trace(trace: InvocationTrace, to_multiple: int = 1024) -> InvocationTrace:
    """Pad arrays so fleets of traces share one jitted shape."""
    k = trace.fn_id.shape[0]
    rem = (-k) % to_multiple
    if rem == 0:
        return trace
    return dataclasses.replace(
        trace,
        fn_id=np.concatenate([trace.fn_id, np.full(rem, -1, np.int32)]),
        start=np.concatenate([trace.start, np.zeros(rem, np.float32)]),
        end=np.concatenate([trace.end, np.zeros(rem, np.float32)]),
    )
