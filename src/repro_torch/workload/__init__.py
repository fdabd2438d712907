"""FaaS workload substrate: function registry, traces, Azure-style generation."""

from repro_torch.workload.functions import FunctionSpec, FunctionRegistry, paper_functions, arch_functions
from repro_torch.workload.trace import InvocationTrace, concat_traces, drop_function, pad_trace
from repro_torch.workload.azure import WorkloadConfig, fleet_traces, generate_trace

__all__ = [
    "FunctionSpec",
    "FunctionRegistry",
    "paper_functions",
    "arch_functions",
    "InvocationTrace",
    "concat_traces",
    "drop_function",
    "pad_trace",
    "WorkloadConfig",
    "fleet_traces",
    "generate_trace",
]
