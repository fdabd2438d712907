"""Function registry (paper Table 2 + model-invocation functions).

A ``FunctionSpec`` carries what the *simulator* knows (true mean power draw
while running, latency distribution, resource mix) — the profiler never sees
these; it must recover them from telemetry.  The resource mix feeds the
per-source sensitivity: chip-power sensors only see ``cpu_frac`` of the
dynamic power (how the paper's `dd` breaks CPU-only profilers).

Two populations:

- ``paper_functions()``: the seven functionbench functions of Table 2, with
  the paper's desktop latencies.
- ``arch_functions()``: model-invocation classes over the assigned
  architectures (``<arch>/prefill``, ``<arch>/decode``, ``<arch>/train``),
  with power/latency derived from each arch's FLOP count — the framework's
  tenant population.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    name: str
    mean_latency_s: float
    latency_cov: float          # coefficient of variation of latency
    dyn_power_w: float          # true mean dynamic power draw while running
    cpu_frac: float = 1.0       # fraction of dyn power visible to chip sensor
    mem_gb: float = 0.5         # for GB-second pricing comparisons
    # Per-invocation step counters (TPU analogue of perf counters):
    gflops: float = 1.0
    hbm_gb: float = 0.1


class FunctionRegistry:
    """Ordered FaaS function set with stable ids and name lookup."""
    def __init__(self, specs: list[FunctionSpec]):
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("duplicate function names")
        self.specs = list(specs)
        self.index = {s.name: i for i, s in enumerate(specs)}

    def __len__(self) -> int:
        return len(self.specs)

    def __getitem__(self, key: int | str) -> FunctionSpec:
        if isinstance(key, str):
            return self.specs[self.index[key]]
        return self.specs[key]

    @property
    def names(self) -> list[str]:
        return [s.name for s in self.specs]

    def without(self, name: str) -> "FunctionRegistry":
        """Registry minus one function — keeps ids stable for marginal traces
        by construction at the trace level (see trace.drop_function)."""
        return FunctionRegistry([s for s in self.specs if s.name != name])


def paper_functions() -> FunctionRegistry:
    """Table 2 functions; latencies are the paper's desktop warm latencies.

    Dynamic powers are simulator ground truth chosen to span the paper's
    observed footprint range (Fig. 3: ~5-100 J/invocation); `dd` and `json`
    are I/O-heavy (low cpu_frac) which is what defeats CPU-only profilers.
    """
    return FunctionRegistry(
        [
            FunctionSpec("dd", 0.7, 0.25, 22.0, cpu_frac=0.35, mem_gb=0.25, gflops=0.5, hbm_gb=2.0),
            FunctionSpec("image", 1.5, 0.20, 28.0, cpu_frac=0.90, mem_gb=0.5, gflops=12.0, hbm_gb=0.8),
            FunctionSpec("video", 7.8, 0.30, 35.0, cpu_frac=0.85, mem_gb=1.0, gflops=90.0, hbm_gb=6.0),
            FunctionSpec("AES", 1.4, 0.15, 30.0, cpu_frac=0.95, mem_gb=0.25, gflops=8.0, hbm_gb=0.3),
            FunctionSpec("json", 0.25, 0.20, 18.0, cpu_frac=0.60, mem_gb=0.25, gflops=0.3, hbm_gb=0.5),
            FunctionSpec("CNN", 1.3, 0.18, 40.0, cpu_frac=0.80, mem_gb=1.0, gflops=35.0, hbm_gb=1.5),
            FunctionSpec("ml_train", 5.1, 0.22, 45.0, cpu_frac=0.92, mem_gb=1.5, gflops=120.0, hbm_gb=4.0),
        ]
    )


#: TPU v5e-flavored constants used to derive invocation-class specs.
_V5E_PEAK_TFLOPS = 197.0
_V5E_DYN_W = 160.0   # dynamic chip watts at full utilization
_V5E_IDLE_W = 60.0


def arch_functions(archs: dict[str, dict] | None = None) -> FunctionRegistry:
    """Model-invocation function classes for the assigned architectures.

    ``archs`` maps arch name -> {"gflops_per_call", "latency_s", "mfu"};
    when omitted a representative default population is used (full derivation
    from configs lives in repro.configs.registry.arch_invocation_specs).
    """
    if archs is None:
        archs = {
            "internlm2-1.8b/decode": dict(gflops_per_call=3.6, latency_s=0.02, mfu=0.08),
            "granite-3-8b/prefill": dict(gflops_per_call=65536.0, latency_s=1.4, mfu=0.45),
            "olmoe-1b-7b/decode": dict(gflops_per_call=2.6, latency_s=0.015, mfu=0.05),
            "xlstm-350m/train": dict(gflops_per_call=8600.0, latency_s=0.9, mfu=0.35),
        }
    specs = []
    for name, d in archs.items():
        util = min(max(d["mfu"], 0.02), 1.0)
        specs.append(
            FunctionSpec(
                name=name,
                mean_latency_s=d["latency_s"],
                latency_cov=0.15,
                dyn_power_w=_V5E_DYN_W * util,
                cpu_frac=0.9,
                mem_gb=8.0,
                gflops=d["gflops_per_call"],
                hbm_gb=d["gflops_per_call"] / 300.0,
            )
        )
    return FunctionRegistry(specs)
