"""Telemetry substrate: power models and simulated sensor front-ends.

On real deployments these modules wrap host telemetry readers (IPMI/BMC,
plug meters via SCPI, RAPL, tegrastats — paper §5).  Here the same
interfaces are backed by a physically-grounded simulator whose ground truth
the profiler never sees.  Numpy throughout; ``simulator`` hands the window
grid over as float32 CPU tensors.
"""

from repro_torch.telemetry.power_model import PowerModelConfig, NodePowerModel
from repro_torch.telemetry.sources import (
    FleetPowerSignal,
    FleetStreamingSensor,
    FleetWindowResampler,
    PowerSignal,
    SensorConfig,
    resample_fleet,
    resample_to_windows,
    sense,
    sense_fleet,
)
from repro_torch.telemetry.simulator import NodeSimulator, SimResult, SimulatorConfig

__all__ = [
    "PowerModelConfig",
    "NodePowerModel",
    "SensorConfig",
    "PowerSignal",
    "FleetPowerSignal",
    "FleetStreamingSensor",
    "FleetWindowResampler",
    "sense",
    "sense_fleet",
    "resample_to_windows",
    "resample_fleet",
    "NodeSimulator",
    "SimResult",
    "SimulatorConfig",
]
