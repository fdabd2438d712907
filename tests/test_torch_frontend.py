"""Port vs reference: the numpy host front end (workload + telemetry).

The port copies these modules; the same seeds must give bitwise the same
traces and telemetry, with the telemetry handed over as float32 CPU tensors
at the same boundary where the reference builds float32 JAX arrays.
"""

import numpy as np
import pytest
import torch

from repro.telemetry.simulator import NodeSimulator as RefSimulator
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.workload.azure import WorkloadConfig as RefWorkloadConfig
from repro.workload.azure import fleet_traces as ref_fleet_traces
from repro.workload.azure import generate_trace as ref_generate_trace
from repro.workload.functions import paper_functions as ref_paper_functions
from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
from repro_torch.workload.azure import WorkloadConfig, fleet_traces, generate_trace
from repro_torch.workload.functions import paper_functions

_SERIES = ("system_power", "chip_power", "cp_cpu_frac", "sys_cpu_frac")


def _assert_trace_equal(ref, port):
    np.testing.assert_array_equal(ref.fn_id, port.fn_id)
    np.testing.assert_array_equal(ref.start, port.start)
    np.testing.assert_array_equal(ref.end, port.end)
    assert (ref.num_fns, ref.duration, ref.fn_names) == (port.num_fns, port.duration, port.fn_names)


def _assert_telemetry_equal(ref, port):
    for name in _SERIES:
        r, p = getattr(ref, name), getattr(port, name)
        if r is None:
            assert p is None, name
            continue
        assert isinstance(p, torch.Tensor) and p.dtype == torch.float32 and p.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(r), p.numpy(), err_msg=name)
    assert ref.idle_watts == port.idle_watts


@pytest.mark.parametrize("kw", [
    dict(duration_s=120.0, load=1.0, seed=3),
    dict(duration_s=90.0, load=2.0, arrival="bursty", seed=5),
    dict(duration_s=60.0, arrival="closed", concurrency=2, seed=9),
])
def test_generate_trace_bitwise(kw):
    ref = ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(**kw))
    port = generate_trace(paper_functions(), WorkloadConfig(**kw))
    _assert_trace_equal(ref, port)


def test_fleet_traces_bitwise():
    ref = ref_fleet_traces(ref_paper_functions(), RefWorkloadConfig(duration_s=60.0, seed=4), 3)
    port = fleet_traces(paper_functions(), WorkloadConfig(duration_s=60.0, seed=4), 3)
    for r, p in zip(ref, port):
        _assert_trace_equal(r, p)


@pytest.mark.parametrize("platform", ["server", "desktop", "edge"])
def test_simulate_bitwise(platform):
    kw = dict(duration_s=80.0, seed=11)
    ref_tr = ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(**kw))
    tr = generate_trace(paper_functions(), WorkloadConfig(**kw))
    ref = RefSimulator(ref_paper_functions(), RefSimConfig(platform=platform)).simulate(ref_tr, seed=2)
    port = NodeSimulator(paper_functions(), SimulatorConfig(platform=platform)).simulate(tr, seed=2)
    _assert_telemetry_equal(ref.telemetry, port.telemetry)
    assert ref.num_windows == port.num_windows
    assert ref.measured_energy_j == port.measured_energy_j
    np.testing.assert_array_equal(ref.true_fn_power_w, port.true_fn_power_w)


def test_simulate_fleet_bitwise_ragged_mixed():
    """A ragged, mixed-platform fleet: every node's telemetry bitwise."""
    durations = [50.0, 30.0, 40.0]
    platforms = ["server", "edge", "desktop"]
    ref_trs = [
        ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=d, seed=30 + i))
        for i, d in enumerate(durations)
    ]
    trs = [
        generate_trace(paper_functions(), WorkloadConfig(duration_s=d, seed=30 + i))
        for i, d in enumerate(durations)
    ]
    ref = RefSimulator(ref_paper_functions(), RefSimConfig()).simulate_fleet(
        ref_trs, seeds=[11, 12, 13], platforms=platforms
    )
    port = NodeSimulator(paper_functions(), SimulatorConfig()).simulate_fleet(
        trs, seeds=[11, 12, 13], platforms=platforms
    )
    for r, p in zip(ref, port):
        _assert_telemetry_equal(r.telemetry, p.telemetry)
        assert r.measured_energy_j == p.measured_energy_j
        np.testing.assert_array_equal(r.true_fn_energy_j, p.true_fn_energy_j)
