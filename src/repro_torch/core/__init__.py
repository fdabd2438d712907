"""The paper's contribution: FaasMeter energy metrology, in PyTorch.

Module map (paper section -> module):

- §4.1 statistical power disaggregation -> ``contribution``, ``disaggregation``
- §4.2 online Kalman estimation         -> ``kalman``
- §4.4 Shapley fair attribution         -> ``shapley``, ``footprints``
- §5   skew sync                        -> ``sync``
- §5.1 validation metrics               -> ``metrics``
- fleet segment engine                  -> ``engine``
- orchestrator                          -> ``profiler``

Not yet ported (ROADMAP.md Queue 1): the CPU power model (§4.3), capping,
pricing, baselines and the streaming sessions.
"""

from repro_torch.core.contribution import (
    augment_with_principals,
    contribution_matrix,
    invocation_counts,
    shared_principal_contribution,
)
from repro_torch.core.disaggregation import (
    DisaggregationConfig,
    disaggregate,
    solve_nnls,
    solve_nnls_gram,
    solve_ridge,
)
from repro_torch.core.kalman import KalmanConfig, KalmanState, kalman_init, kalman_step, run_kalman
from repro_torch.core.metrics import (
    coefficient_of_variation,
    cosine_similarity,
    individual_difference,
    latency_normalized_variance,
    marginal_energy,
    total_power_error,
)
from repro_torch.core.profiler import (
    FaasMeterProfiler,
    FootprintReport,
    ProfilerConfig,
    Telemetry,
    fleet_profile,
    fleet_profile_batched,
)
from repro_torch.core.shapley import (
    shapley_control_plane_share,
    shapley_idle_share,
    total_footprint,
)
from repro_torch.core.sync import apply_shift, estimate_skew, synchronize

__all__ = [
    "augment_with_principals",
    "contribution_matrix",
    "invocation_counts",
    "shared_principal_contribution",
    "DisaggregationConfig",
    "disaggregate",
    "solve_nnls",
    "solve_nnls_gram",
    "solve_ridge",
    "KalmanConfig",
    "KalmanState",
    "kalman_init",
    "kalman_step",
    "run_kalman",
    "coefficient_of_variation",
    "cosine_similarity",
    "individual_difference",
    "latency_normalized_variance",
    "marginal_energy",
    "total_power_error",
    "FaasMeterProfiler",
    "FootprintReport",
    "ProfilerConfig",
    "Telemetry",
    "fleet_profile",
    "fleet_profile_batched",
    "shapley_control_plane_share",
    "shapley_idle_share",
    "total_footprint",
    "apply_shift",
    "estimate_skew",
    "synchronize",
]
