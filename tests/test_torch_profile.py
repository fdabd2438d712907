"""Port vs reference: the metering slice end to end.

Trace -> simulated telemetry -> sync -> contribution matrices -> X_0 NNLS
-> Kalman -> Shapley footprint reports, once per node
(``FaasMeterProfiler.profile``) and fleet-batched
(``fleet_profile_batched``), with both packages fed the same seeded inputs.
Report fields are pinned at 1e-5 of their scale (the solvers' last-bit
sensitivity, see tests/test_torch_core.py); the estimated skew at 1e-5
windows, compared first because a flipped near-tie moves everything after
it.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.profiler import FaasMeterProfiler as RefProfiler
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.core.profiler import fleet_profile_batched as ref_fleet_profile_batched
from repro.telemetry.simulator import NodeSimulator as RefSimulator
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.workload.azure import WorkloadConfig, generate_trace
from repro.workload.functions import paper_functions
from repro_torch.convert import config_from_reference_fields, telemetry_from_numpy
from repro_torch.core.profiler import (
    FaasMeterProfiler,
    ProfilerConfig,
    fleet_profile,
    fleet_profile_batched,
)

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _telemetry(ref_tel):
    """The reference's telemetry handed over as numpy, as a user would."""
    f = lambda x: None if x is None else np.asarray(x)
    return telemetry_from_numpy(
        f(ref_tel.system_power), f(ref_tel.chip_power), ref_tel.idle_watts,
        f(ref_tel.cp_cpu_frac), f(ref_tel.sys_cpu_frac), device="cpu",
    )


def _scaled(port, ref, rel=1e-5):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port, np.float64)
    return float(np.max(np.abs(port - ref))) <= rel * max(1.0, float(np.abs(ref).max()))


def _assert_report(port, ref, what=""):
    assert abs(port.skew_windows - ref.skew_windows) <= 1e-5, (what, port.skew_windows, ref.skew_windows)
    for name in ("x_power", "x_trajectory", "x_cp", "mean_latency", "invocations"):
        assert _scaled(getattr(port, name), getattr(ref, name)), (what, name)
    for name in ("j_indiv", "phi_cp", "phi_idle", "j_total", "per_invocation"):
        assert _scaled(getattr(port.spectrum, name), getattr(ref.spectrum, name)), (what, name)
    for name in ("cp_energy", "idle_energy", "total_error"):
        assert _scaled(getattr(port, name), getattr(ref, name)), (what, name)


def _ref_profiler(pc):
    return RefProfiler(RefProfilerConfig(**pc))


def _port_profiler(pc):
    cfg = config_from_reference_fields(ProfilerConfig, dataclasses.asdict(RefProfilerConfig(**pc)))
    assert cfg == ProfilerConfig(**pc)
    return FaasMeterProfiler(cfg)


@pytest.mark.parametrize("platform", ["desktop", "server", "edge"])
def test_profile_matches_reference(short_trace, platform):
    """Per-node profile on the conftest trace (tests/test_profiler_e2e.py's
    config): the edge platform has no chip sensor, so no sync."""
    pc = dict(init_windows=60, step_windows=30)
    sim = RefSimulator(paper_functions(), RefSimConfig(platform=platform)).simulate(short_trace)
    tr = short_trace
    ref = _ref_profiler(pc).profile(
        jnp.asarray(tr.fn_id), jnp.asarray(tr.start), jnp.asarray(tr.end),
        num_fns=tr.num_fns, duration=tr.duration, telemetry=sim.telemetry,
    )
    port = _port_profiler(pc).profile(
        tr.fn_id, tr.start, tr.end, num_fns=tr.num_fns, duration=tr.duration,
        telemetry=_telemetry(sim.telemetry), device="cpu",
    )
    _assert_report(port, ref, platform)


def _fleet(durations, seed0=20):
    traces = [
        generate_trace(paper_functions(), WorkloadConfig(duration_s=d, seed=seed0 + i))
        for i, d in enumerate(durations)
    ]
    sims = RefSimulator(paper_functions(), RefSimConfig(platform="server")).simulate_fleet(traces)
    return traces, sims


@pytest.mark.parametrize("durations", [[300.0] * 3, [300.0, 230.0, 170.0]])
def test_fleet_profile_batched_matches_reference(durations):
    """3 nodes x 300 s on the server platform with a chip sensor (so sync
    runs), dense and ragged; the per-node path agrees too."""
    traces, sims = _fleet(durations)
    dur = durations if len(set(durations)) > 1 else durations[0]
    ref = ref_fleet_profile_batched(
        RefProfiler(RefProfilerConfig()),
        [(jnp.asarray(t.fn_id), jnp.asarray(t.start), jnp.asarray(t.end)) for t in traces],
        [s.telemetry for s in sims], num_fns=7, duration=dur,
    )
    profiler = FaasMeterProfiler(ProfilerConfig())
    args = ([(t.fn_id, t.start, t.end) for t in traces], [_telemetry(s.telemetry) for s in sims])
    port = fleet_profile_batched(profiler, *args, num_fns=7, duration=dur, device="cpu")
    per_node = fleet_profile(profiler, *args, num_fns=7, duration=dur, device="cpu")
    assert len(port) == len(ref) == 3
    for i, (p, r, q) in enumerate(zip(port, ref, per_node)):
        _assert_report(p, r, f"node {i}")
        _assert_report(q, r, f"per-node {i}")
        # Efficiency of the spectrum: every joule of the segment is assigned.
        total = float(p.spectrum.j_indiv.sum()) + p.cp_energy + p.idle_energy
        assert abs(float(p.spectrum.j_total.sum()) - total) <= 1e-5 * total


def test_combined_mode_and_mesh_are_not_ported():
    """Combined mode is ported now (tests/test_torch_combined.py): it
    constructs, and without its counter inputs raises ``ValueError`` as the
    reference does; an unknown mode is refused.  A node-axis mesh is ported
    (tests/test_torch_sharded.py): an empty fleet on a one-entry mesh gives
    no reports, and a fleet that does not tile the mesh is refused."""
    from repro_torch.distributed import fleet_mesh

    combined = FaasMeterProfiler(ProfilerConfig(mode="combined"))
    with pytest.raises(ValueError, match="fn_counters"):
        fleet_profile_batched(combined, [], [], num_fns=7, duration=300.0, device="cpu")
    with pytest.raises(ValueError, match="unknown profiler mode"):
        FaasMeterProfiler(ProfilerConfig(mode="hybrid"))
    assert fleet_profile_batched(
        FaasMeterProfiler(), [], [], num_fns=7, duration=300.0, mesh=fleet_mesh(devices=["cpu"])
    ) == []
    traces, sims = _fleet((300.0, 300.0))
    with pytest.raises(ValueError, match="not divisible"):
        fleet_profile_batched(
            FaasMeterProfiler(), [(t.fn_id, t.start, t.end) for t in traces],
            [_telemetry(s.telemetry) for s in sims], num_fns=7, duration=300.0,
            mesh=fleet_mesh(devices=["cpu"] * 3),
        )


def test_entry_points_default_to_cuda_and_raise_without_it(short_trace):
    """No device= means the card; without one the call raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    sim = RefSimulator(paper_functions(), RefSimConfig()).simulate(short_trace)
    tel = _telemetry(sim.telemetry)
    tr = short_trace
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FaasMeterProfiler().profile(tr.fn_id, tr.start, tr.end, num_fns=7, duration=tr.duration, telemetry=tel)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_profile_batched(
            FaasMeterProfiler(), [(tr.fn_id, tr.start, tr.end)], [tel], num_fns=7, duration=tr.duration
        )
    from repro_torch.core.engine import run_fleet, synthetic_fleet

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_fleet(2, 2, 4, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fleet(synthetic_fleet(2, 2, 4, 3, device="cpu"))


def test_port_imports_neither_jax_nor_reference():
    """Importing the port and running its slice on the CPU loads no module
    of JAX or of the reference package."""
    code = textwrap.dedent(
        """
        import sys
        import repro_torch, repro_torch.convert, repro_torch.core, repro_torch.kernels.ops
        from repro_torch.workload.azure import WorkloadConfig, fleet_traces
        from repro_torch.workload.functions import paper_functions
        from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
        from repro_torch.core.profiler import FaasMeterProfiler, ProfilerConfig, fleet_profile_batched
        reg = paper_functions()
        traces = fleet_traces(reg, WorkloadConfig(duration_s=160.0), 2)
        sims = NodeSimulator(reg, SimulatorConfig()).simulate_fleet(traces)
        reports = fleet_profile_batched(
            FaasMeterProfiler(ProfilerConfig(init_windows=40, step_windows=30)),
            [(t.fn_id, t.start, t.end) for t in traces], [s.telemetry for s in sims],
            num_fns=len(reg), duration=160.0, device="cpu",
        )
        assert len(reports) == 2
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO_SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
