"""Port vs reference: the reference's last public names and the port's
import surfaces.

``activity_series`` (counts of small integers) and ``denoise_median3`` (a
median picks one of its inputs) are held exactly; ``per_invocation_energy``
at 1e-6 relative; ``attention_dense`` and ``models.common.dense`` within
1e-5 of their scale.  Every input is drawn from a numpy seed and fed to
both packages.  The snapshots pin the port's ``__all__`` exactly, as
``tests/test_api_surface.py`` pins the reference's: each holds the
reference's exports (``tests/test_torch_twins.py`` checks the containment
for every package) and the port's own additions.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.contribution as ref_contrib
import repro.core.disaggregation as ref_dis
import repro.core.sync as ref_sync
import repro.kernels.ref as ref_kref
import repro.models.common as ref_common
import repro_torch.core.contribution as contrib
import repro_torch.core.disaggregation as dis
import repro_torch.core.sync as sync
import repro_torch.kernels.ref as kref
import repro_torch.models.common as common


# ---------------------------------------------------------------------------
# activity_series
# ---------------------------------------------------------------------------


def _trace(rng, n, m, t0, dt, num_bins):
    """Invocations over a window wider than the grid on both sides: some
    start before ``t0``, some end past its last bin, some are padding."""
    span = num_bins * dt
    start = rng.uniform(t0 - 0.3 * span, t0 + 1.1 * span, n).astype(np.float32)
    end = (start + rng.exponential(0.2 * span, n)).astype(np.float32)
    fn_id = rng.integers(0, m, n).astype(np.int32)
    fn_id[rng.random(n) < 0.1] = -1
    return fn_id, start, end


@pytest.mark.parametrize("t0", [0.0, 3.7])
@pytest.mark.parametrize("dt", [0.01, 1.0])
def test_activity_series_exact(t0, dt):
    rng = np.random.default_rng(int(t0 * 10) + int(dt * 100))
    m, num_bins = 5, 240
    fn_id, start, end = _trace(rng, 600, m, t0, dt, num_bins)
    # the cases the grid's edges decide, each present
    grid_end = t0 + num_bins * dt
    assert (start < t0).any() and ((start < t0) & (end >= t0) & (end < grid_end) & (fn_id >= 0)).any()
    assert ((start < grid_end) & (end >= grid_end)).any() and (fn_id < 0).any()
    want = np.asarray(ref_contrib.activity_series(
        jnp.asarray(fn_id), jnp.asarray(start), jnp.asarray(end), num_fns=m, num_bins=num_bins, t0=t0, dt=dt))
    got = contrib.activity_series(
        torch.from_numpy(fn_id), torch.from_numpy(start), torch.from_numpy(end),
        num_fns=m, num_bins=num_bins, t0=t0, dt=dt)
    assert got.dtype == torch.float32 and got.shape == (num_bins, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() > 1  # overlapping invocations were counted


# ---------------------------------------------------------------------------
# denoise_median3, per_invocation_energy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (97,), (40, 3)])
def test_denoise_median3_exact(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    w = rng.normal(120.0, 4.0, shape).astype(np.float32)
    w[shape[0] // 2] += 900.0  # a spike
    want = np.asarray(ref_sync.denoise_median3(jnp.asarray(w)))
    got = sync.denoise_median3(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[0] >= 3:
        assert got.max() < 200.0  # the spike is gone


def test_per_invocation_energy():
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 80.0, 9).astype(np.float32)
    tau = rng.uniform(0.01, 5.0, 9).astype(np.float32)
    want = np.asarray(ref_dis.per_invocation_energy(jnp.asarray(x), jnp.asarray(tau)))
    got = dis.per_invocation_energy(torch.from_numpy(x), torch.from_numpy(tau))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# attention_dense, dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,s,t", [(4, 4, 16, 16), (8, 2, 16, 16), (8, 2, 6, 19), (4, 4, 5, 12)])
def test_attention_dense(causal, h, hkv, s, t):
    rng = np.random.default_rng(h * 31 + hkv * 7 + s + t)
    q = rng.normal(size=(2, s, h, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, t, hkv, 16)).astype(np.float32) for _ in range(2))
    want = np.asarray(ref_kref.attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = kref.attention_dense(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_attention_dense_scale_and_dtype():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 8, 4, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(ref_kref.attention_dense(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), scale=0.3))
    got = kref.attention_dense(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), scale=0.3)
    assert got.dtype == torch.bfloat16
    # the fp32 results agree to 1e-5 of scale; the cast to bf16 may round them a step apart
    assert np.abs(got.float().numpy() - want.astype(np.float32)).max() <= 2 ** -7 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32) if bias else None
    want = np.asarray(ref_common.dense(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b)))
    got = common.dense(torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# The port's import surfaces
# ---------------------------------------------------------------------------

SNAPSHOTS = {
    "repro_torch.core": [
        "activity_series", "augment_with_principals", "contribution_matrix", "invocation_counts",
        "shared_principal_contribution", "DisaggregationConfig", "disaggregate", "per_invocation_energy",
        "solve_nnls", "solve_nnls_gram", "solve_ridge", "KalmanConfig", "KalmanState", "kalman_init",
        "kalman_step", "run_kalman", "CpuModelConfig", "LinearPowerModel", "fit_linear_svr", "fit_ridge",
        "predict_function_power", "predict_power", "coefficient_of_variation", "cosine_similarity",
        "individual_difference", "latency_normalized_variance", "marginal_energy", "total_power_error",
        "FaasMeterProfiler", "FootprintReport", "ProfilerConfig", "Telemetry", "fleet_profile",
        "fleet_profile_batched", "prepare_combined_fleet", "shapley_control_plane_share", "shapley_idle_share",
        "total_footprint", "apply_shift", "estimate_skew", "synchronize", "CappingConfig", "PowerCapController",
    ],
    "repro_torch.serving": [
        "CapRunResult", "ControlConfig", "ControlLoop", "EnergyAwareScheduler", "EnergyFirstControlPlane",
        "Invocation", "KeepAliveCache", "MeteredServer", "ProfiledWorkload", "SchedulerConfig", "SchedulerStats",
        "SlotAdmissionQueue", "SlotRequest", "StreamingFootprintTracker", "energy_aware_placement",
    ],
    "repro_torch.telemetry": [
        "PowerModelConfig", "NodePowerModel", "SensorConfig", "PowerSignal", "FleetPowerSignal",
        "FleetStreamingSensor", "FleetWindowResampler", "sense", "sense_fleet", "resample_to_windows",
        "resample_fleet", "window_counters", "function_counters", "NodeSimulator", "SimResult", "SimulatorConfig",
    ],
    "repro_torch.models": ["ModelApi", "TensorSpec", "build", "extend_cache", "model_flops"],
}


@pytest.mark.parametrize("pkg", sorted(SNAPSHOTS))
def test_port_all_matches_snapshot(pkg):
    got, want = sorted(importlib.import_module(pkg).__all__), sorted(SNAPSHOTS[pkg])
    assert got == want, f"{pkg}.__all__ drifted: missing {sorted(set(want) - set(got))}, new {sorted(set(got) - set(want))}"
    ref = importlib.import_module(pkg.replace("repro_torch", "repro"))
    assert set(ref.__all__) <= set(got), sorted(set(ref.__all__) - set(got))


@pytest.mark.parametrize("pkg", sorted(SNAPSHOTS))
def test_port_export_resolves(pkg):
    mod = importlib.import_module(pkg)
    assert not [n for n in mod.__all__ if not hasattr(mod, n)]
