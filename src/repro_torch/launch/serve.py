"""Serving launcher: the energy-first serving path end to end -- the twin of
the reference's ``repro/launch/serve.py``.

Serves real (reduced) models on one device as FaaS function classes,
meters every invocation, and reports FaasMeter energy footprints + prices
-- the paper's full pipeline (Fig. 1) on live compute::

    PYTHONPATH=src python -m repro_torch.launch.serve --archs internlm2-1.8b \
        --requests 40 --batch 2 --seq 64 [--device cpu]

Same CLI and defaults as the reference, plus ``--device`` (default
``cuda``); the default ``--archs`` serve the dense, xLSTM and MoE families.
An architecture whose family the port does not have yet raises, as in the
reference.  Weights come from a seeded ``torch.Generator`` on the device;
prompts (and a VLM's patch embeddings) from a seeded numpy generator.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.pricing import PricingConfig, price_report
from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import materialize
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import compute_dtype
from repro_torch.serving.control_plane import MeteredServer
from repro_torch.serving.engine import ServeEngine
from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
from repro_torch.workload.functions import FunctionRegistry, FunctionSpec


def random_batch(api, shape: ShapeConfig, rng: np.random.Generator, device) -> dict:
    """Prompt inputs for ``api`` at ``shape``, drawn from ``rng`` in the
    specs' order, as the reference's launcher draws them: token ids uniform
    over the true vocabulary, float inputs (patch embeddings) standard
    normal times 0.1."""
    batch = {}
    for k, sp in api.prefill_inputs(shape).items():
        if sp.dtype.is_floating_point:
            x = rng.standard_normal(sp.shape) * 0.1
        else:
            x = rng.integers(0, api.cfg.vocab_size, size=sp.shape)
        batch[k] = torch.as_tensor(x, dtype=sp.dtype, device=device)
    return batch


def meter_trace(server: MeteredServer, trace, *, device, init_windows: int = 20, step_windows: int = 10):
    """Meter a measured trace through the simulated telemetry and the
    profiler, and price it.  Returns (report, prices)."""
    lat = trace.end - trace.start
    specs = []
    for i, name in enumerate(server.order):
        mask = trace.fn_id == i
        mean_lat = float(lat[mask].mean()) if mask.any() else 0.1
        specs.append(FunctionSpec(name, mean_lat, 0.2, dyn_power_w=25.0 + 5.0 * i, cpu_frac=0.9))
    registry = FunctionRegistry(specs)
    sim = NodeSimulator(registry, SimulatorConfig(platform="desktop")).simulate(trace)
    report = FaasMeterProfiler(ProfilerConfig(init_windows=init_windows, step_windows=step_windows)).profile(
        trace.fn_id, trace.start, trace.end,
        num_fns=trace.num_fns, duration=trace.duration, telemetry=sim.telemetry, device=device,
    )
    prices = price_report(
        report.spectrum.j_indiv, report.spectrum.j_total, report.invocations,
        report.mean_latency, torch.ones(trace.num_fns, device=report.invocations.device), PricingConfig(),
    )
    return report, prices


def main(argv: list[str] | None = None) -> None:
    """CLI: serving smoke across the port's model-zoo architectures."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="internlm2-1.8b,xlstm-350m,olmoe-1b-7b")
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--gen-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    archs = args.archs.split(",")
    apis = {name: build(get_config(name, reduced=True)) for name in archs}
    shape = ShapeConfig("serve", args.seq, args.batch, "prefill")
    server = MeteredServer()
    rng = np.random.default_rng(args.seed)

    print(f"== registering function classes (reduced configs, real compute on {dev}) ==")
    for name, api in apis.items():
        cfg = api.cfg
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = materialize(api.params_def, gen, compute_dtype(cfg))
        engine = ServeEngine(api, shape, params)
        server.register(f"{name}/generate", engine, random_batch(api, shape, rng, dev), steps=args.gen_steps)
        print(f"  {name}/generate registered")

    schedule = [(f"{archs[i % len(archs)]}/generate", 0.0) for i in range(args.requests)]
    print(f"== serving {len(schedule)} requests ==")
    trace = server.serve(schedule, duration=60.0)
    lat = trace.end - trace.start
    print(f"   measured warm latencies: mean={lat.mean():.3f}s p95={np.quantile(lat, 0.95):.3f}s")

    report, prices = meter_trace(server, trace, device=dev)
    print("== FaasMeter footprints ==")
    for i, name in enumerate(server.order):
        print(
            f"  {name:32s} J/inv={float(report.spectrum.per_invocation[i]):8.2f} "
            f"(indiv {float(report.spectrum.per_invocation_indiv[i]):7.2f}) "
            f"usd/inv={float(prices['total_usd_per_inv'][i]):.2e} "
            f"carbon g/inv={float(prices['carbon_g_per_inv'][i]):.3f}"
        )
    print(f"  total-error={report.total_error:.3f} skew={report.skew_windows:+.1f}w")


if __name__ == "__main__":
    main()
