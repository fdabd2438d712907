#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on past):

1. Device and build: requires CUDA, prints the card's name and power limit,
   switches TF32 off, builds the CUDA kernel from ``src/repro_torch`` with
   nvcc and prints the build time and ptxas report.
2. Kernel parity: the CUDA ``disagg_gram`` against its plain PyTorch
   version on the card, at the main path's shapes, the kernel docstring's M
   range and ragged shapes; per shape the kernel's, the plain version's and
   ``torch.bmm``'s device times (cold L2) and the memory/compute bound.
3. Main path: the paper's Table 2 functions (7 + the control-plane
   principal, M = 8) on 64 server nodes x 1800 s (paper §6 segments, delta
   1 s, N_init 100, N_K 60, so S = 28): simulate the fleet, profile it with
   ``fleet_profile_batched`` (64 footprint reports), then build the same
   fleet's engine inputs and run ``run_fleet_gram`` (backend "auto": the
   kernel assembles the X_0 gram and every step's gram) against
   ``run_fleet``.  Kernel launch counts are zeroed just before this phase
   and read just after.
   Each of the two engine calls is then replayed under torch.profiler for
   its device busy and idle share.
4. Small-input agreement: the same profiling on 3 nodes x 300 s on the card
   and on the CPU.

Output: one line per measurement, then a ``{"kernels": [...]}`` JSON line,
the ``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; no network.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth and
# fp32 rate outside the tensor cores (the kernel uses plain fp32 FMAs).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

B_NODES, DURATION_S, PLATFORM = 64, 1800.0, "server"
N_INIT, N_K = 100, 60  # ProfilerConfig defaults (paper §6)
S_STEPS = (int(DURATION_S) - N_INIT) // N_K
MAIN_SHAPES = [(B_NODES * S_STEPS, N_K, 8), (B_NODES, N_INIT, 8)]  # step hoist, X_0
PARITY_SHAPES = MAIN_SHAPES + [(64, 1800, 64), (8, 1000, 256), (4, 1, 5), (6, 197, 5), (16, 130, 17)]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def gram_work(g: int, n: int, m: int) -> tuple[float, float]:
    """(bytes, flops) of one gram assembly: inputs read once, outputs written
    once, 2 flops per multiply-add of C^T C and C^T w."""
    nbytes = 4.0 * (g * n * m + g * n + g * m * m + g * m)
    flops = 2.0 * g * n * m * m + 2.0 * g * n * m
    return nbytes, flops


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn()`` in ms, L2 flushed before each run.

    A 128 MB write evicts the 50 MB L2, then a spin kernel keeps the GPU
    busy while the host enqueues the timed launch, so the events bracket
    device work only, not Python launch overhead.
    """
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(ds) -> float:
    t0 = time.perf_counter()
    ptxas = ds.build()
    dt = time.perf_counter() - t0
    for line in ptxas.strip().splitlines():
        log(f"  nvcc: {line.strip()}")
    log(f"build: disagg_gram.cu -> sm_90a in {dt:.2f} s")
    return dt


def phase_kernel_parity(ds, ref) -> dict:
    """Kernel vs plain on the card at every listed shape; returns the main
    shapes' timings."""
    rng = np.random.default_rng(0)
    rows = {}
    for g, n, m in PARITY_SHAPES:
        c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32)).cuda()
        w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).cuda()
        gram, rhs = ds.disagg_gram(c, w)
        torch.cuda.synchronize()
        pg, pr = ref.disagg_gram(c, w)
        # An N-term fp32 sum taken in another order: rtol 1e-5 plus an atol
        # of 1e-6 * N * max|C| * max(|C|, |w|).
        cmax = float(c.abs().max())
        atol = 1e-6 * n * cmax * max(cmax, float(w.abs().max()))
        err = max(float((gram - pg).abs().max()), float((rhs - pr).abs().max()))
        torch.testing.assert_close(gram, pg, rtol=1e-5, atol=atol)
        torch.testing.assert_close(rhs, pr, rtol=1e-5, atol=atol)
        cw = torch.cat([c, w[..., None]], dim=-1)  # bmm(cw^T, cw) holds gram and rhs
        t_kernel = device_ms(lambda: ds.disagg_gram(c, w))
        t_plain = device_ms(lambda: ref.disagg_gram(c, w))
        t_lib = device_ms(lambda: torch.bmm(cw.mT, cw))
        nbytes, flops = gram_work(g, n, m)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        rows[(g, n, m)] = dict(
            err=err, ms=t_kernel, plain_ms=t_plain, library_ms=t_lib, bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S else "operations",
        )
        log(
            f"parity G={g} N={n} M={m}: max_abs_err={err:.3e} (atol {atol:.3e}) "
            f"kernel_ms={t_kernel:.5f} plain_ms={t_plain:.5f} library_ms={t_lib:.5f} "
            f"bound_us={bound * 1e3:.3f} ({rows[(g, n, m)]['bound_by']})"
        )
    return rows


def _engine_inputs(traces, sims, device, n):
    """Per-node C (with the control-plane column, M = 8), A and the idle-
    adjusted power, packed into the main path's (B, S, N_K, 8) batch plus
    the N_INIT window X_0 block."""
    from repro_torch.core.contribution import (
        augment_with_principals,
        contribution_matrix,
        invocation_counts,
        shared_principal_contribution,
    )
    from repro_torch.core.engine import pack_fleet_inputs

    m = traces[0].num_fns
    cs, a_s, ws = [], [], []
    for tr, sim in zip(traces, sims):
        tel = sim.telemetry.to(device)
        fn_id = torch.as_tensor(tr.fn_id, dtype=torch.int64, device=device)
        start = torch.as_tensor(tr.start, device=device)
        end = torch.as_tensor(tr.end, device=device)
        cp = shared_principal_contribution(tel.cp_cpu_frac[:n], tel.sys_cpu_frac[:n])
        cs.append(augment_with_principals(
            contribution_matrix(fn_id, start, end, num_fns=m, num_windows=n), cp
        ))
        a = invocation_counts(fn_id, start, num_fns=m, num_windows=n)
        # The principal is always active: one pseudo-invocation per Kalman
        # step, on the step's first window (as the profiler counts it).
        first = ((torch.arange(n, device=device) - N_INIT) % N_K == 0).to(torch.float32)
        a_s.append(torch.cat([a, first[:, None]], dim=1))
        ws.append(torch.clamp(tel.system_power[:n] - tel.idle_watts, min=0.0))
    c, a, w = torch.stack(cs), torch.stack(a_s), torch.stack(ws)
    zeros = torch.zeros_like(a)
    inputs = pack_fleet_inputs(
        c[:, N_INIT:], w[:, N_INIT:], a[:, N_INIT:], zeros[:, N_INIT:], zeros[:, N_INIT:],
        step_windows=N_K, device=device,
    )
    return inputs, c[:, :N_INIT], w[:, :N_INIT]


def phase_main_path(device: str, b: int = B_NODES, duration: float = DURATION_S):
    """Drive the port's main path on ``device``.  Returns its checks and
    times, and closures that replay its two engine calls for tracing."""
    from repro_torch.core.engine import EngineConfig, run_fleet, run_fleet_gram
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
    from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    reg = paper_functions()
    t0 = time.perf_counter()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=duration, load=1.0), b)
    sims = NodeSimulator(reg, SimulatorConfig(platform=PLATFORM)).simulate_fleet(traces)
    out["simulate_s"] = time.perf_counter() - t0
    out["invocations"] = int(sum(t.num_invocations for t in traces))

    def profile():
        return fleet_profile_batched(
            FaasMeterProfiler(ProfilerConfig()),
            [(t.fn_id, t.start, t.end) for t in traces],
            [s.telemetry for s in sims],
            num_fns=len(reg), duration=duration, device=device,
        )

    t0 = time.perf_counter()
    reports = profile()
    sync()
    out["profile_s"] = time.perf_counter() - t0
    assert len(reports) == b, len(reports)
    errs, eff = [], []
    for rep, sim in zip(reports, sims):
        x = rep.x_power.cpu().numpy()
        assert rep.x_power.device.type == device and x.shape == (len(reg),)
        assert np.all(np.isfinite(x)) and np.all(x >= 0.0)
        assert np.all(np.isfinite(rep.x_trajectory.cpu().numpy()))
        total = float(rep.spectrum.j_indiv.sum()) + rep.cp_energy + rep.idle_energy
        eff.append(abs(float(rep.spectrum.j_total.sum()) - total) / total)
        truth = sim.true_fn_power_w
        ok = truth > 0
        errs.extend(np.abs(x[ok] - truth[ok]) / truth[ok])
    assert max(eff) <= 1e-5, max(eff)
    out["reports"] = len(reports)
    out["efficiency_max_rel_err"] = max(eff)
    out["median_footprint_err"] = float(np.median(errs))

    t0 = time.perf_counter()
    inputs, init_c, init_w = _engine_inputs(traces, sims, device, int(duration))
    sync()
    out["pack_s"] = time.perf_counter() - t0
    out["engine_shape"] = list(inputs.c.shape)
    cfg = EngineConfig()
    t0 = time.perf_counter()
    gram_res = run_fleet_gram(inputs, cfg, init_c=init_c, init_w=init_w, device=device)
    sync()
    out["run_fleet_gram_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_res = run_fleet(inputs, cfg, init_c=init_c, init_w=init_w, device=device)
    sync()
    out["run_fleet_s"] = time.perf_counter() - t0
    d = float((gram_res.x_final - raw_res.x_final).abs().max())
    out["gram_vs_raw_max_abs"] = d
    out["x_final_max"] = float(raw_res.x_final.abs().max())
    measured = inputs.w.reshape(b, -1)
    recon = gram_res.tick_power.sum(-1) + gram_res.unattributed
    cons = float((recon - measured).abs().max()) / float(measured.abs().max())
    out["conservation_rel"] = cons
    assert torch.isfinite(gram_res.x_trajectory).all()
    assert cons <= 1e-5, cons
    replays = {
        "fleet_profile_batched": (profile, out["profile_s"]),
        "run_fleet_gram": (
            lambda: run_fleet_gram(inputs, cfg, init_c=init_c, init_w=init_w, device=device),
            out["run_fleet_gram_s"],
        ),
    }
    return out, replays


def phase_trace(replays) -> None:
    """Replay each main-path call warm, untraced and then under
    torch.profiler: device busy time is the sum of the traced run's CUDA
    kernel intervals (one stream, so they do not overlap), idle share is
    1 - busy / the warm untraced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, (fn, first_wall) in replays.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            log(f"trace {name}: no device events recorded; device busy share not measured")
            continue
        busy = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(
            f"trace {name}: first_call_s={first_wall:.4f} warm_wall_s={wall:.4f} traced_wall_s={traced:.4f} "
            f"device_busy_s={busy:.4f} idle_share={1.0 - busy / wall:.4f} "
            f"kernels={len(kernels)}"
        )
        for kname, ms in top:
            log(f"trace {name}:   {ms:9.3f} ms  {kname[:90]}")


def phase_small_agreement() -> float:
    """The same profiling of a small fleet on the card and on the CPU:
    returns max |card - cpu| over report estimates, relative to their scale."""
    from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
    from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
    from repro_torch.workload.azure import WorkloadConfig, fleet_traces
    from repro_torch.workload.functions import paper_functions

    reg = paper_functions()
    traces = fleet_traces(reg, WorkloadConfig(duration_s=300.0, seed=20), 3)
    sims = NodeSimulator(reg, SimulatorConfig(platform=PLATFORM)).simulate_fleet(traces)
    args = ([(t.fn_id, t.start, t.end) for t in traces], [s.telemetry for s in sims])
    worst = 0.0
    runs = {
        dev: fleet_profile_batched(FaasMeterProfiler(), *args, num_fns=len(reg), duration=300.0, device=dev)
        for dev in ("cuda", "cpu")
    }
    for rg, rc in zip(runs["cuda"], runs["cpu"]):
        assert abs(rg.skew_windows - rc.skew_windows) <= 1e-4, (rg.skew_windows, rc.skew_windows)
        for a, b in ((rg.x_power, rc.x_power), (rg.x_trajectory, rc.x_trajectory),
                     (rg.spectrum.j_total, rc.spectrum.j_total)):
            a, b = a.cpu().double(), b.double()
            worst = max(worst, float((a - b).abs().max()) / max(1.0, float(b.abs().max())))
    # FISTA amplifies last-bit differences of sums taken in another order
    # on the card; 1e-4 of the scale is 10x the CPU pins against the reference.
    assert worst <= 1e-4, worst
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import disagg_solve as ds
        from repro_torch.kernels import ref
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {SRC}: {exc}", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = phase_build(ds)
    rows = phase_kernel_parity(ds, ref)

    # Main path: counts zeroed just before, read just after; the plain
    # version is watched so a CUDA tensor provably never reaches it.
    plain_calls = []
    plain = ref.disagg_gram

    def watched(c, w):
        plain_calls.append(c.device.type)
        return plain(c, w)

    ref.disagg_gram = watched
    ds.disagg_gram.launches = 0
    try:
        main_out, replays = phase_main_path("cuda")
    finally:
        ref.disagg_gram = plain
    launches = ds.disagg_gram.launches
    assert launches == 2, f"run_fleet_gram should launch disagg_gram twice (X_0 + step hoist), got {launches}"
    assert "cuda" not in plain_calls, plain_calls
    assert main_out["gram_vs_raw_max_abs"] <= 5e-5 * max(1.0, main_out["x_final_max"]), main_out
    for k, v in main_out.items():
        log(f"main_path {k}: {v}")
    log(f"main_path disagg_gram launches: {launches}")

    phase_trace(replays)

    worst = phase_small_agreement()
    log(f"small fleet card vs cpu: max rel diff {worst:.3e}")

    main_rows = [rows[s] for s in MAIN_SHAPES]
    kernels = [{
        "name": "disagg_gram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/disagg_gram.cu",
        "replaces": "src/repro/kernels/disagg_solve.py:84",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in main_rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main_rows) else "operations",
        "library_ms": sum(r["library_ms"] for r in main_rows),
        "shapes": [list(s) for s in MAIN_SHAPES],
    }]
    log(f"build_s {build_s:.2f} total_s {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
