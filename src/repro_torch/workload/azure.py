"""Azure-Functions-style workload generation (paper §2.1, §6; trace [73]).

The Azure trace's salient statistics, reproduced here:

- inter-arrival times are heavy-tailed across functions (0.01 s .. 1 day);
  we draw per-function mean IATs from a log-normal spanning the requested
  load range, and per-invocation IATs from the chosen arrival process;
- execution times range 0.1 s .. 100 s and are function-specific
  (log-normal around each FunctionSpec's mean with its CoV);
- arrival processes: Poisson (exponential IATs), bursty (Markov-modulated
  on/off), or closed-loop (next starts after previous ends, Fig. 2a's shape).

Generation is numpy (host-side data plane); everything downstream is PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.workload.functions import FunctionRegistry
from repro_torch.workload.trace import InvocationTrace


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    duration_s: float = 1800.0        # paper: 30-minute traces
    load: float = 1.0                 # target utilization scale (1.0 ~ 100 %)
    arrival: str = "poisson"          # poisson | bursty | closed
    burst_on_s: float = 30.0          # bursty: mean on-period
    burst_off_s: float = 20.0         # bursty: mean off-period
    burst_factor: float = 4.0         # rate multiplier during bursts
    concurrency: int = 1              # closed-loop: parallel loops per fn
    iat_spread: float = 1.0           # log-normal sigma of per-fn mean IATs
    seed: int = 0
    max_invocations: int = 200_000


def _fn_rates(registry: FunctionRegistry, cfg: WorkloadConfig, rng) -> np.ndarray:
    """Per-function arrival rates targeting the requested load.

    Load ~= sum_j rate_j * latency_j (expected concurrent invocations).
    Heavy-tailed heterogeneity enters through log-normal rate multipliers.
    """
    m = len(registry)
    lat = np.array([s.mean_latency_s for s in registry.specs])
    mult = rng.lognormal(0.0, cfg.iat_spread, size=m)
    base = mult / np.sum(mult * lat)  # sum(base * lat) == 1 concurrent
    return base * cfg.load * max(m, 1) / 2.0


def generate_trace(
    registry: FunctionRegistry, cfg: WorkloadConfig = WorkloadConfig()
) -> InvocationTrace:
    """Sample an invocation trace for the registry under ``cfg``."""
    rng = np.random.default_rng(cfg.seed)
    fn_ids, starts, ends = [], [], []

    if cfg.arrival == "closed":
        for j, spec in enumerate(registry.specs):
            for c in range(cfg.concurrency):
                t = rng.uniform(0, spec.mean_latency_s)
                while t < cfg.duration_s:
                    dur = _latency(rng, spec)
                    fn_ids.append(j)
                    starts.append(t)
                    ends.append(min(t + dur, cfg.duration_s))
                    t += dur + rng.exponential(0.05 * spec.mean_latency_s)
    else:
        rates = _fn_rates(registry, cfg, rng)
        for j, spec in enumerate(registry.specs):
            t = 0.0
            rate = max(rates[j], 1e-6)
            burst_state, state_left = True, rng.exponential(cfg.burst_on_s)
            while t < cfg.duration_s:
                r = rate
                if cfg.arrival == "bursty":
                    r = rate * (cfg.burst_factor if burst_state else 1.0 / cfg.burst_factor)
                iat = rng.exponential(1.0 / r)
                if cfg.arrival == "bursty":
                    state_left -= iat
                    if state_left <= 0:
                        burst_state = not burst_state
                        state_left = rng.exponential(
                            cfg.burst_on_s if burst_state else cfg.burst_off_s
                        )
                t += iat
                if t >= cfg.duration_s:
                    break
                dur = _latency(rng, spec)
                fn_ids.append(j)
                starts.append(t)
                ends.append(min(t + dur, cfg.duration_s))

    k = len(fn_ids)
    if k > cfg.max_invocations:
        raise ValueError(f"trace too large: {k} invocations")
    order = np.argsort(starts) if k else np.array([], np.int64)
    return InvocationTrace(
        fn_id=np.array(fn_ids, np.int32)[order],
        start=np.array(starts, np.float32)[order],
        end=np.array(ends, np.float32)[order],
        num_fns=len(registry),
        duration=cfg.duration_s,
        fn_names=registry.names,
    )


def fleet_traces(
    registry: FunctionRegistry, cfg: WorkloadConfig, num_nodes: int
) -> list[InvocationTrace]:
    """Per-node Azure-style traces for a fleet replay.

    Node ``i`` draws from ``cfg`` with ``seed + i`` — independent arrival
    processes with identical load statistics, the trace-scale input to
    ``EnergyFirstControlPlane.profile_fleet(control=...)`` and the
    control-loop benchmark.  Deterministic: the same (cfg, num_nodes) gives
    bitwise-identical traces.
    """
    return [
        generate_trace(registry, dataclasses.replace(cfg, seed=cfg.seed + i))
        for i in range(num_nodes)
    ]


def _latency(rng, spec) -> float:
    """Log-normal latency with the spec's mean and CoV."""
    cov = max(spec.latency_cov, 1e-3)
    sigma2 = np.log(1.0 + cov * cov)
    mu = np.log(spec.mean_latency_s) - 0.5 * sigma2
    return float(rng.lognormal(mu, np.sqrt(sigma2)))
