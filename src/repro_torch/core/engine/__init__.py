"""Layered fleet segment engine: the paper's pipeline as composable stages.

Module DAG, imports only downward:

    types        dataclasses/NamedTuples shared by every stage
    masking      the single definition of ragged-fleet semantics
    estimate     whole-trace X_0 solves (§4.2) + gram backends
    attribution  conserved per-tick splits + §4.4 spectra
    plan         FleetPlan: resolve_plan / finish_result / segment_plan
    segment      run_fleet / run_fleet_gram / run_fleet_sequential
    packing      per-window arrays → (B, S, n_w, ...) batches

Not yet ported (see ROADMAP.md): the streaming engine, length buckets,
combined-mode targets and mesh sharding.
"""

from repro_torch.core.engine.attribution import fleet_spectrum, tick_attribution
from repro_torch.core.engine.estimate import fleet_initial_estimate
from repro_torch.core.engine.packing import pack_fleet_inputs, synthetic_fleet
from repro_torch.core.engine.plan import FleetPlan, finish_result, resolve_plan, segment_plan
from repro_torch.core.engine.segment import run_fleet, run_fleet_gram, run_fleet_sequential
from repro_torch.core.engine.types import EngineConfig, FleetInputs, FleetResult

__all__ = [
    "EngineConfig",
    "FleetInputs",
    "FleetPlan",
    "FleetResult",
    "finish_result",
    "fleet_initial_estimate",
    "fleet_spectrum",
    "pack_fleet_inputs",
    "resolve_plan",
    "run_fleet",
    "run_fleet_gram",
    "run_fleet_sequential",
    "segment_plan",
    "synthetic_fleet",
    "tick_attribution",
]
