"""Real-execution metered server -- the twin of ``MeteredServer`` in the
reference's ``repro/serving/control_plane.py``.

The rest of that module (the energy-first control plane, the control loop,
capping and streaming footprints) is ROADMAP Queue 1 items 5-7.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.workload.trace import InvocationTrace


class MeteredServer:
    """Serve real models and meter them through FaasMeter.

    Each registered (name, engine, batch) is a FaaS function class; ``serve``
    executes a request schedule and collects the *measured* invocation
    trace, which the caller profiles -- the energy-first serving path on
    live compute.  (The reference's unused ``profiler_config`` argument is
    dropped.)
    """

    def __init__(self):
        self.functions: dict[str, tuple] = {}
        self.order: list[str] = []

    def register(self, name: str, engine, batch: dict, *, steps: int = 4) -> None:
        self.functions[name] = (engine, batch, steps)
        self.order.append(name)

    def serve(self, schedule: list[tuple[str, float]], duration: float) -> InvocationTrace:
        """Run (function, at_time) requests back-to-back; wall-clock metered.

        Returns an InvocationTrace in *relative* time with real latencies.
        A function's first request starts it cold (``warmup``), outside the
        metered span.
        """
        t_base = time.perf_counter()
        fn_ids, starts, ends = [], [], []
        for name, _at in schedule:
            engine, batch, steps = self.functions[name]
            if engine.cold:
                engine.warmup(batch)  # cold start, not metered as warm
            t0 = time.perf_counter() - t_base
            engine.generate(batch, steps)
            t1 = time.perf_counter() - t_base
            fn_ids.append(self.order.index(name))
            starts.append(t0)
            ends.append(t1)
        total = max(duration, (ends[-1] if ends else 0.0) + 1.0)
        return InvocationTrace(
            fn_id=np.asarray(fn_ids, np.int32),
            start=np.asarray(starts, np.float32),
            end=np.asarray(ends, np.float32),
            num_fns=len(self.order),
            duration=float(np.ceil(total)),
            fn_names=list(self.order),
        )
