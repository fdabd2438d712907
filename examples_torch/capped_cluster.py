"""Software power capping in action (paper Fig. 10 as a runnable scenario),
on the PyTorch port.

    PYTHONPATH=src python examples_torch/capped_cluster.py [--device cpu]

The twin of ``examples/capped_cluster.py``: a bursty workload hits a node
under three power caps; admission uses live FaasMeter footprints
(estimated on ``--device``, default ``cuda``, not oracle).  Prints the
overshoot / latency trade-off and the footprint-vs-static-buffer
comparison.
"""

import argparse

import numpy as np

from repro_torch.serving.control_plane import EnergyFirstControlPlane
from repro_torch.telemetry.simulator import SimulatorConfig
from repro_torch.workload.azure import WorkloadConfig, generate_trace
from repro_torch.workload.functions import paper_functions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    reg = paper_functions()
    trace = generate_trace(reg, WorkloadConfig(duration_s=240.0, load=1.2, seed=6, arrival="bursty"))
    cp = EnergyFirstControlPlane(reg, SimulatorConfig(platform="server"), device=args.device)
    fp = cp.profile_trace(trace).report.spectrum.per_invocation_indiv.cpu().numpy()
    uncapped = cp.run_capped(trace, cap_watts=1e9)
    base = float(np.quantile(uncapped.power_series, 0.9))
    print(f"uncapped p90 power: {base:.0f} W\n")
    print(f"{'cap':>6s} {'overshoot%':>10s} {'mag%':>6s} {'mean lat':>9s} {'p95 wait':>9s}")
    for frac in (0.75, 0.9, 1.05):
        res = cp.run_capped(trace, cap_watts=frac * base, footprints=fp)
        print(
            f"{frac * base:6.0f} {100 * res.overshoot_fraction:10.2f} "
            f"{100 * res.mean_overshoot_magnitude:6.2f} {res.latencies.mean():9.2f} "
            f"{np.quantile(res.queue_waits, 0.95):9.2f}"
        )
    buf = cp.run_capped(trace, cap_watts=0.9 * base, use_footprints=False)
    print(
        f"\nstatic 20 W buffer at {0.9 * base:.0f} W: overshoot "
        f"{100 * buf.overshoot_fraction:.1f}% of samples — the buffer can't see "
        "per-function increments (the paper's motivation for footprints)"
    )


if __name__ == "__main__":
    main()
