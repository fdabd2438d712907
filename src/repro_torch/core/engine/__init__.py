"""Layered fleet engine: the paper's pipeline as composable stages.

Module DAG, imports only downward:

    types        dataclasses/NamedTuples shared by every stage
    masking      the single definition of ragged-fleet semantics
    estimate     whole-trace X_0 solves (§4.2) + gram backends
    attribution  conserved per-tick splits + §4.4 spectra
    plan         FleetPlan: resolve_plan / finish_result / segment_plan
    segment      run_fleet / run_fleet_gram / run_fleet_sequential
    streaming    fleet_step / run_fleet_stream: one update per tick
    packing      per-window arrays → (B, S, n_w, ...) batches
    targets      pure vs §4.3 combined ('rest') disaggregation targets

Not yet ported (see ROADMAP.md): length buckets and mesh sharding (Queue 1
item 8).
"""

from repro_torch.core.engine.attribution import fleet_spectrum, tick_attribution
from repro_torch.core.engine.estimate import fleet_initial_estimate
from repro_torch.core.engine.packing import pack_fleet_inputs, synthetic_fleet
from repro_torch.core.engine.plan import FleetPlan, finish_result, resolve_plan, segment_plan
from repro_torch.core.engine.segment import run_fleet, run_fleet_gram, run_fleet_sequential
from repro_torch.core.engine.streaming import (
    fleet_step,
    fleet_stream_init,
    fleet_stream_reset_slots,
    fleet_ticks,
    run_fleet_stream,
)
from repro_torch.core.engine.targets import combined_rest_target, fleet_rest_idle
from repro_torch.core.engine.types import (
    EngineConfig,
    FleetInputs,
    FleetResult,
    FleetStep,
    FleetStreamState,
    TickAttribution,
)

__all__ = [
    "EngineConfig",
    "FleetInputs",
    "FleetPlan",
    "FleetResult",
    "FleetStep",
    "FleetStreamState",
    "TickAttribution",
    "combined_rest_target",
    "finish_result",
    "fleet_initial_estimate",
    "fleet_rest_idle",
    "fleet_spectrum",
    "fleet_step",
    "fleet_stream_init",
    "fleet_stream_reset_slots",
    "fleet_ticks",
    "pack_fleet_inputs",
    "resolve_plan",
    "run_fleet",
    "run_fleet_gram",
    "run_fleet_sequential",
    "run_fleet_stream",
    "segment_plan",
    "synthetic_fleet",
    "tick_attribution",
]
