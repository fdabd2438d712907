"""The paper's contribution: FaasMeter energy metrology, in PyTorch.

Module map (paper section -> module):

- §4.1 statistical power disaggregation -> ``contribution``, ``disaggregation``
- §4.2 online Kalman estimation         -> ``kalman``
- §4.3 CPU power modeling               -> ``cpu_model``
- §4.4 Shapley fair attribution         -> ``shapley``, ``footprints``
- §5   skew sync + power capping        -> ``sync``, ``capping``
- §5.1 validation metrics               -> ``metrics``
- §6   pricing                          -> ``pricing``
- fleet engine (segment + streaming)    -> ``engine``
- live sessions                         -> ``sessions``
- orchestrator                          -> ``profiler``

Not yet ported (ROADMAP.md Queue 1): the baselines (item 13).
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
from repro_torch.core.cpu_model import (
    CpuModelConfig,
    LinearPowerModel,
    fit_linear_svr,
    fit_ridge,
    predict_function_power,
    predict_power,
)
from repro_torch.core.profiler import (
    FaasMeterProfiler,
    FootprintReport,
    ProfilerConfig,
    Telemetry,
    fleet_profile,
    fleet_profile_batched,
    prepare_combined_fleet,
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
    "CpuModelConfig",
    "LinearPowerModel",
    "fit_linear_svr",
    "fit_ridge",
    "predict_function_power",
    "predict_power",
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
    "prepare_combined_fleet",
    "shapley_control_plane_share",
    "shapley_idle_share",
    "total_footprint",
    "apply_shift",
    "estimate_skew",
    "synchronize",
]
