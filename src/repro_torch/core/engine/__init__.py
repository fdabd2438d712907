"""Layered fleet engine: the paper's pipeline as composable stages.

Module DAG, imports only downward:

    types        dataclasses/NamedTuples shared by every stage
    masking      the single definition of ragged-fleet semantics
    estimate     whole-trace X_0 solves (§4.2) + gram backends
    attribution  conserved per-tick splits + §4.4 spectra
    plan         FleetPlan: resolve_plan / finish_result / segment_plan
    sharding     dispatch of any stage over a FleetMesh, shard by shard
    segment      run_fleet / run_fleet_gram / run_fleet_sequential
    streaming    fleet_step / fleet_stream_reset_slots / run_fleet_stream
    packing      per-window arrays → (B, S, n_w, ...) batches
    buckets      length buckets: bucketed init solves and segment packs
    targets      pure vs §4.3 combined ('rest') disaggregation targets
"""

from repro_torch.core.engine.attribution import fleet_spectrum, tick_attribution
from repro_torch.core.engine.buckets import (
    DEFAULT_BUCKETS,
    FleetBucket,
    bucket_for,
    bucketed_initial_estimate,
    bucketed_pad_waste,
    pack_fleet_buckets,
    pad_waste_frac,
    run_fleet_bucketed,
    warm_bucket_solvers,
)
from repro_torch.core.engine.estimate import fleet_initial_estimate
from repro_torch.core.engine.masking import fold_step_valid
from repro_torch.core.engine.packing import (
    pack_fleet_inputs,
    synthetic_fleet,
    synthetic_ragged_windows,
)
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
    "DEFAULT_BUCKETS",
    "EngineConfig",
    "FleetBucket",
    "FleetInputs",
    "FleetPlan",
    "FleetResult",
    "FleetStep",
    "FleetStreamState",
    "TickAttribution",
    "bucket_for",
    "bucketed_initial_estimate",
    "bucketed_pad_waste",
    "combined_rest_target",
    "finish_result",
    "fleet_initial_estimate",
    "fleet_rest_idle",
    "fleet_spectrum",
    "fleet_step",
    "fleet_stream_init",
    "fleet_stream_reset_slots",
    "fleet_ticks",
    "fold_step_valid",
    "pack_fleet_buckets",
    "pack_fleet_inputs",
    "pad_waste_frac",
    "resolve_plan",
    "run_fleet",
    "run_fleet_bucketed",
    "run_fleet_gram",
    "run_fleet_sequential",
    "run_fleet_stream",
    "segment_plan",
    "synthetic_fleet",
    "synthetic_ragged_windows",
    "tick_attribution",
    "warm_bucket_solvers",
]
