"""Quickstart: profile a FaaS workload with the PyTorch port of FaasMeter.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The twin of ``examples/quickstart.py``: generates an Azure-style trace for
the paper's Table-2 functions, simulates desktop telemetry (plug-meter
pathology), runs the full FaasMeter pipeline (sync -> disaggregation ->
Kalman -> Shapley) on ``--device`` (default ``cuda``), and validates
against the marginal-energy ground truth (paper Eq. 6).
"""

import argparse

import numpy as np
import torch

from repro_torch.core.metrics import cosine_similarity
from repro_torch.serving.control_plane import EnergyFirstControlPlane
from repro_torch.telemetry.simulator import SimulatorConfig
from repro_torch.workload.azure import WorkloadConfig, generate_trace
from repro_torch.workload.functions import paper_functions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    registry = paper_functions()
    trace = generate_trace(registry, WorkloadConfig(duration_s=300.0, load=1.0, seed=0))
    print(f"trace: {trace.num_invocations} invocations of {trace.num_fns} functions over {trace.duration:.0f}s")

    cp = EnergyFirstControlPlane(registry, SimulatorConfig(platform="desktop"), device=args.device)
    prof = cp.profile_trace(trace)
    spec = prof.report.spectrum

    print(f"\n{'function':10s} {'J/inv':>8s} {'indiv':>8s} {'phi_cp':>7s} {'phi_idle':>8s} {'$/1M inv':>9s}")
    for j, name in enumerate(registry.names):
        inv = max(float(prof.report.invocations[j]), 1.0)
        print(
            f"{name:10s} {float(spec.per_invocation[j]):8.2f} "
            f"{float(spec.per_invocation_indiv[j]):8.2f} "
            f"{float(spec.phi_cp[j]) / inv:7.3f} {float(spec.phi_idle[j]) / inv:8.2f} "
            f"{float(prof.prices['total_usd_per_inv'][j]) * 1e6:9.2f}"
        )
    print(f"\ntotal-error={prof.report.total_error:.3f}  sensor skew={prof.report.skew_windows:+.1f} windows")

    # External validation: marginal energy (Eq. 6) for the first active functions.
    active = [j for j in range(trace.num_fns) if trace.invocations_of(j) > 0][:4]
    marginal = np.array([cp.marginal_energy(trace, j) for j in active])
    est = spec.per_invocation_indiv[active].cpu()
    cos = float(cosine_similarity(est, torch.as_tensor(marginal, dtype=torch.float32)))
    print(f"cosine vs marginal-energy ground truth: {cos:.4f} (paper: 0.984-0.998)")


if __name__ == "__main__":
    main()
