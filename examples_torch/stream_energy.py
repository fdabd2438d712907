"""Live fleet energy metering on the PyTorch port: footprints, prices, and
cap checks per tick.

    PYTHONPATH=src python examples_torch/stream_energy.py [--device cpu]

The twin of ``examples/stream_energy.py``: telemetry flows out of
``NodeSimulator.stream_fleet`` one delta-window at a time, into a
``StreamingFleetSession`` on ``--device`` (default ``cuda``) that
bootstraps X_0 on the init segment and then advances the streaming engine
(``fleet_step``) tick by tick.  The ``on_tick`` hook (numpy ``StreamTick``
records) shows what an energy-first control plane does *during* the
segment, not after it:

- folds every tick's causal attribution into per-node
  ``StreamingFootprintTracker``s (live J/invocation);
- prices the running footprints (live $/invocation);
- feeds attributed fleet power to a ``PowerCapController`` and reports
  would-be admission decisions against a software cap.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.capping import CappingConfig, PowerCapController
from repro_torch.core.pricing import energy_price_usd
from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig
from repro_torch.serving.control_plane import StreamingFootprintTracker
from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
from repro_torch.workload.azure import WorkloadConfig, generate_trace
from repro_torch.workload.functions import paper_functions

DURATION = 240.0
NODES = 2
CAP_WATTS = 460.0  # fleet-level software cap (2 nodes, ~95 W idle each)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    registry = paper_functions()
    traces = [generate_trace(registry, WorkloadConfig(duration_s=DURATION, load=1.2, seed=s)) for s in range(NODES)]
    sim = NodeSimulator(registry, SimulatorConfig(platform="server"))

    profiler = FaasMeterProfiler(ProfilerConfig(init_windows=60, step_windows=30))
    num_fns = traces[0].num_fns
    idle_w = sim.power_cfg.idle_w
    trackers = [StreamingFootprintTracker(num_fns, idle_watts=idle_w) for _ in range(NODES)]
    cap = PowerCapController(CappingConfig(power_cap_watts=CAP_WATTS, control_interval_s=1.0))
    names = registry.names

    def on_bootstrap(sess):
        print(
            f"[t={sess.init_n:4d}s] bootstrap: skew="
            + "/".join(f"{s:+.1f}" for s in sess.skews)
            + " windows, X_0 solved for "
            f"{sess.b} nodes x {sess.m_aug} principals"
        )
        x0, busy, inv = (t.cpu().numpy() for t in (sess.x0, sess.init_busy_seconds, sess.init_invocations))
        for i, tr in enumerate(trackers):
            tr.observe_step(x0[i], busy[i], inv[i], sess.init_seconds)

    def on_tick(tick):
        for i, tr in enumerate(trackers):
            tr.observe_tick(tick.x[i], tick.busy_seconds[i], tick.a[i], 1.0)
        # Live capping view: attributed fleet power vs the software cap.
        fleet_watts = float(tick.tick_power.sum() + tick.unattributed.sum()) + idle_w * NODES
        cap.observe_power(fleet_watts)
        if tick.t % 30 == 0 or tick.step_completed:
            j_inv = trackers[0].per_invocation_indiv
            price = energy_price_usd(torch.as_tensor(j_inv)).numpy()
            top = np.argsort(-j_inv)[:3]
            live = "  ".join(f"{names[j]}={j_inv[j]:.1f}J (${price[j] * 1e6:.2f}/M)" for j in top)
            tag = "step" if tick.step_completed else "tick"
            headroom = CAP_WATTS - fleet_watts
            print(
                f"[t={tick.t:4d}s] {tag}: fleet {fleet_watts:6.1f}W "
                f"(cap {CAP_WATTS:.0f}W, headroom {headroom:+6.1f}W)  node0: {live}"
            )

    session = profiler.start_fleet_stream(
        [(t.fn_id, t.start, t.end) for t in traces],
        num_fns=num_fns,
        duration=DURATION,
        idle_watts=[idle_w] * NODES,
        has_chip=True,
        has_cp=True,
        on_tick=on_tick,
        on_bootstrap=on_bootstrap,
        device=args.device,
    )

    print(f"streaming {int(DURATION)} windows of {NODES}-node telemetry ...")
    for tick in sim.stream_fleet(traces, seeds=list(range(41, 41 + NODES))):
        session.push_window(w_sys=tick.w_sys, w_chip=tick.w_chip, cp_frac=tick.cp_frac, sys_frac=tick.sys_frac)
    reports = session.finalize()

    print("\nfinal reports (same _finalize_report as the segment paths):")
    for i, rep in enumerate(reports):
        print(
            f"  node{i}: total-error={rep.total_error:.3f} "
            f"skew={rep.skew_windows:+.1f}w cp={rep.cp_energy:.0f}J "
            f"idle={rep.idle_energy:.0f}J"
        )
    print("\nlive tracker vs final report (node 0, J/invocation, active fns):")
    tr = trackers[0]
    per_inv_rep = reports[0].spectrum.per_invocation_indiv.cpu().numpy()
    for j in range(num_fns):
        if tr.invocations[j] > 0:
            print(
                f"  {names[j]:10s} live={tr.per_invocation_indiv[j]:7.2f}  "
                f"report={per_inv_rep[j]:7.2f}  inv={int(tr.invocations[j])}"
            )
    print(f"\ncap stats: {cap.stats.overshoot_samples} overshoot samples / {int(DURATION) - 60} observed ticks")


if __name__ == "__main__":
    main()
