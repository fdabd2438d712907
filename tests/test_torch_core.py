"""Port vs reference: the math leaves of the metering path.

Contribution matrices, clock sync, the NNLS/ridge solvers, the Kalman
filter (raw and gram-hoisted), Shapley shares and footprints — each fed the
same seeded numpy inputs in both packages.

Tolerances.  Solver outputs are pinned at 1e-5 of the solution's scale
(``max|port - ref| <= 1e-5 * max(1, max|ref|)``): FISTA amplifies last-bit
differences, and the reference's own ``solve_nnls_gram`` moves by ~1e-4 W
on a 64-function problem when its rhs changes by one ulp, so an absolute
1e-5 W pin between two frameworks that sum in different orders would test
rounding order, not the port.  Contribution cells are pinned at two
float32 spacings of the largest cumulative running-time curve (at least
2e-4 s): C is a difference of such curves, which reach ~10^3 s on an
1800-window trace.  ``1 - K A`` is held exactly: the port rounds it once,
as the reference's fused multiply-add does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.contribution as ref_contrib
import repro.core.disaggregation as ref_dis
import repro.core.footprints as ref_fp
import repro.core.kalman as ref_kal
import repro.core.metrics as ref_met
import repro.core.shapley as ref_shap
import repro.core.sync as ref_sync
import repro_torch.core.contribution as contrib
import repro_torch.core.disaggregation as dis
import repro_torch.core.footprints as fp
import repro_torch.core.kalman as kal
import repro_torch.core.metrics as met
import repro_torch.core.shapley as shap
import repro_torch.core.sync as sync
from repro.workload.azure import WorkloadConfig, generate_trace
from repro.workload.functions import paper_functions

REL = 1e-5


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def assert_scaled(port, ref, rel=REL, what=""):
    """max|port - ref| <= rel * max(1, max|ref|) (see module docstring)."""
    ref = np.asarray(ref, np.float64)
    port = port.detach().numpy().astype(np.float64) if isinstance(port, torch.Tensor) else np.asarray(port, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.max(np.abs(port - ref))) if ref.size else 0.0
    assert err <= rel * max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0), (what, err)


# --------------------------------------------------------------- contribution


@pytest.mark.parametrize("duration,seed", [(180.0, 7), (1800.0, 1)])
def test_contribution_and_counts(duration, seed):
    trace = generate_trace(paper_functions(), WorkloadConfig(duration_s=duration, seed=seed))
    n, m = int(duration), trace.num_fns
    ref_c = ref_contrib.contribution_matrix(
        jnp.asarray(trace.fn_id), jnp.asarray(trace.start), jnp.asarray(trace.end),
        num_fns=m, num_windows=n,
    )
    c = contrib.contribution_matrix(
        t(trace.fn_id, torch.int64), t(trace.start), t(trace.end), num_fns=m, num_windows=n
    )
    # Both sides round each cumulative-curve value to float32 (spacing
    # 2.4e-4 s past 2048 s); a cell is a difference of two such values, so
    # two spacings of the largest curve bound the gap.  On the 1800 s trace
    # the reference itself is 4.9e-4 s from the float64 truth.
    busy = np.bincount(trace.fn_id, np.maximum(trace.end - trace.start, 0), m)
    atol = max(2e-4, 2 * float(np.spacing(np.float32(busy.max()))))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=0, atol=atol)
    ref_a = ref_contrib.invocation_counts(
        jnp.asarray(trace.fn_id), jnp.asarray(trace.start), num_fns=m, num_windows=n
    )
    a = contrib.invocation_counts(t(trace.fn_id, torch.int64), t(trace.start), num_fns=m, num_windows=n)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))


def test_contribution_padding_and_principals(rng):
    fn_id = np.array([0, -1, 2, 1, -1], np.int32)
    start = np.array([0.2, 5.0, 1.5, 3.9, 0.0], np.float32)
    end = np.array([2.7, 9.0, 1.8, 6.1, 1.0], np.float32)
    ref_c = ref_contrib.contribution_matrix(
        jnp.asarray(fn_id), jnp.asarray(start), jnp.asarray(end), num_fns=3, num_windows=8, t0=0.5, delta=0.75
    )
    c = contrib.contribution_matrix(
        t(fn_id, torch.int64), t(start), t(end), num_fns=3, num_windows=8, t0=0.5, delta=0.75
    )
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=0, atol=1e-6)
    cp = rng.random(8).astype(np.float32)
    sysf = (rng.random(8) * 0.9 + 0.05).astype(np.float32)
    ref_col = ref_contrib.shared_principal_contribution(j(cp), j(sysf), delta=0.75)
    col = contrib.shared_principal_contribution(t(cp), t(sysf), delta=0.75)
    np.testing.assert_array_equal(col.numpy(), np.asarray(ref_col))
    np.testing.assert_array_equal(
        contrib.augment_with_principals(c, col).numpy(),
        np.asarray(ref_contrib.augment_with_principals(j(c.numpy()), ref_col)),
    )


# ----------------------------------------------------------------------- sync


def _lagged(rng, n=300, lag=5):
    r = 50.0 + 10.0 * (rng.random(n) > 0.6).astype(np.float64)
    r = np.convolve(r, np.ones(3) / 3, mode="same")
    w = np.roll(r, lag)
    w[:lag] = r[0]
    w = w + rng.normal(0, 0.5, size=n)
    return w.astype(np.float32), r.astype(np.float32)


@pytest.mark.parametrize("lag", [0, 2, 5, 9, -4])
def test_estimate_skew_and_synchronize(rng, lag):
    w, r = _lagged(rng, lag=lag)
    ref_aligned, ref_skew = ref_sync.synchronize(j(w), j(r), max_shift=16)
    aligned, skew = sync.synchronize(t(w), t(r), max_shift=16)
    assert abs(float(skew) - float(ref_skew)) <= 1e-5, (float(skew), float(ref_skew))
    np.testing.assert_allclose(aligned.numpy(), np.asarray(ref_aligned), rtol=1e-5)
    for shift in (0.0, 2.25, -3.5, 40.0):
        np.testing.assert_allclose(
            sync.apply_shift(t(w), torch.tensor(shift)).numpy(),
            np.asarray(ref_sync.apply_shift(j(w), jnp.float32(shift))),
            rtol=1e-6,
        )


# -------------------------------------------------------------------- solvers


def _synthetic(rng, n=200, m=6, noise=0.0):
    c = np.abs(rng.standard_normal((n, m))) * (rng.random((n, m)) > 0.5)
    x_true = np.abs(rng.standard_normal(m)) * 30.0 + 5.0
    w = c @ x_true + noise * rng.standard_normal(n)
    return c.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("n,m,noise", [(200, 6, 0.0), (200, 6, 5.0), (300, 64, 1.0)])
def test_solvers_match_reference(rng, n, m, noise):
    c, w = _synthetic(rng, n, m, noise)
    lam = 1e-3
    assert_scaled(dis.solve_ridge(t(c), t(w), lam), ref_dis.solve_ridge(j(c), j(w), lam), what="ridge")
    assert_scaled(
        dis.solve_ridge(t(c), t(w), lam, nonneg=False),
        ref_dis.solve_ridge(j(c), j(w), lam, nonneg=False), what="ridge signed",
    )
    assert_scaled(dis.solve_nnls(t(c), t(w), lam), ref_dis.solve_nnls(j(c), j(w), lam), what="nnls")
    gram = c.T.astype(np.float64) @ c + lam * np.eye(m)
    rhs = c.T.astype(np.float64) @ w
    assert_scaled(
        dis.solve_nnls_gram(t(gram), t(rhs), iters=400),
        ref_dis.solve_nnls_gram(j(gram), j(rhs), iters=400), what="nnls_gram",
    )


def test_nnls_gram_batched(rng):
    """Leading batch dims broadcast as the reference's do."""
    g = rng.standard_normal((3, 2, 5, 5))
    gram = (g @ np.swapaxes(g, -1, -2) + 0.1 * np.eye(5)).astype(np.float32)
    rhs = rng.standard_normal((3, 2, 5)).astype(np.float32)
    assert_scaled(
        dis.solve_nnls_gram(t(gram), t(rhs), iters=50),
        ref_dis.solve_nnls_gram(j(gram), j(rhs), iters=50),
    )


@pytest.mark.parametrize("mode", ["full", "no_idle", "rest"])
@pytest.mark.parametrize("nonneg", [True, False])
def test_disaggregate_modes(rng, mode, nonneg):
    c, w = _synthetic(rng, noise=2.0)
    w = w + 40.0
    w_cpu = (rng.random(c.shape[0]) * 20.0).astype(np.float32)
    ref_cfg = ref_dis.DisaggregationConfig(mode=mode, nonneg=nonneg)
    cfg = dis.DisaggregationConfig(mode=mode, nonneg=nonneg)
    assert_scaled(
        dis.disaggregate(t(c), t(w), cfg, w_idle=40.0, w_cpu=t(w_cpu)),
        ref_dis.disaggregate(j(c), j(w), ref_cfg, w_idle=40.0, w_cpu=j(w_cpu)),
    )


def test_disaggregate_rejects_bad_mode():
    with pytest.raises(ValueError):
        dis.disaggregate(torch.ones(4, 2), torch.ones(4), dis.DisaggregationConfig(mode="nope"))
    with pytest.raises(ValueError):
        dis.disaggregate(torch.ones(4, 2), torch.ones(4), dis.DisaggregationConfig(mode="rest"))


# --------------------------------------------------------------------- kalman


def _assert_state(port, ref, what=""):
    for name, p, r in zip(kal.KalmanState._fields, port, ref):
        if name == "seen":
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=f"{what} seen")
        else:
            assert_scaled(p, r, what=f"{what} {name}")


def _kalman_step_inputs(rng, m, n_w, x_true, active_mask, lat=1.0):
    """The generator of tests/test_kalman.py."""
    c = np.zeros((n_w, m), np.float32)
    for k in range(m):
        if active_mask[k]:
            c[:, k] = np.abs(rng.standard_normal(n_w)) * 0.5
    w = c @ x_true
    a = active_mask.astype(np.float32) * n_w * 0.5
    return c, w.astype(np.float32), a, a * lat, a * lat * lat


def _stability_steps(rng, s, n_w, m, density=0.3):
    """The generator of tests/test_kalman_stability.py."""
    c = np.abs(rng.standard_normal((s, n_w, m))) * (rng.random((s, n_w, m)) > 1 - density)
    x_true = np.abs(rng.standard_normal(m)) * 15.0 + 1.0
    w = np.einsum("snm,m->sn", c, x_true) + 0.05 * rng.standard_normal((s, n_w))
    a = (rng.random((s, m)) > 0.4) * rng.integers(0, 3, (s, m))
    lat = np.abs(rng.standard_normal((s, m)))
    f = lambda x: np.asarray(x, np.float32)
    return f(c), f(np.maximum(w, 0.0)), f(a), f(lat * a), f(lat**2 * a)


def _configs():
    return [
        dict(),
        dict(gamma=0.0),
        dict(gamma=1e-12, r_scale=1e-6),
        dict(alpha=1.0, beta=0.0, gamma=0.0),
    ]


def test_kalman_step_masks_and_new_functions(rng):
    """Inactive functions frozen, new ones take U: equal to the reference."""
    m = 4
    x_true = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    active = np.array([True, True, False, True])
    inputs = _kalman_step_inputs(rng, m, 20, x_true * active, active)
    for x0 in (x_true, None):
        ref_state = ref_kal.kalman_init(m, x0=None if x0 is None else j(x0))
        state = kal.kalman_init(m, x0=None if x0 is None else t(x0), device="cpu")
        _assert_state(state, ref_state, "init")
        ref_new, ref_x = ref_kal.kalman_step(ref_state, *map(j, inputs))
        new, x = kal.kalman_step(state, *map(t, inputs))
        _assert_state(new, ref_new, "step")
        assert_scaled(x, ref_x)
        assert float(new.p[2]) == float(ref_new.p[2])


@pytest.mark.parametrize("kw", _configs())
def test_run_kalman_stability_configs(kw):
    """tests/test_kalman_stability.py inputs under each noise regime, with
    the P >= 0 clamp active on the near-zero-noise configs (fewer steps than
    that file's 600-step horizon, to bound the eager CPU loop's time)."""
    rng = np.random.default_rng(0)
    c, w, a, ls, lq = _stability_steps(rng, 600, 8, 12)
    c, w, a, ls, lq = (x[:120] for x in (c, w, a, ls, lq))
    ref_state, ref_traj = ref_kal.run_kalman(
        ref_kal.kalman_init(12, x0=jnp.ones((12,)) * 5.0), *map(j, (c, w, a, ls, lq)),
        ref_kal.KalmanConfig(**kw),
    )
    state, traj = kal.run_kalman(
        kal.kalman_init(12, x0=torch.ones(12) * 5.0), *map(t, (c, w, a, ls, lq)),
        kal.KalmanConfig(**kw),
    )
    _assert_state(state, ref_state, str(kw))
    assert_scaled(traj, ref_traj)
    assert torch.all(state.p >= 0)


def test_run_kalman_saturating_gain():
    """The K A -> 1 regime of test_kalman_stability: P clamped at 0 exactly
    where the reference clamps it."""
    m = 4
    cfg = dict(gamma=0.0, r_scale=1e-8)
    c = np.zeros((400, 2, m), np.float32)
    c[:, :, 0] = 1.0
    w = np.full((400, 2), 10.0, np.float32)
    a = np.zeros((400, m), np.float32)
    a[:, 0] = 50.0
    args = (c, w, a, a * 0.1, a * 0.01)
    ref_state, ref_traj = ref_kal.run_kalman(
        ref_kal.kalman_init(m, x0=jnp.ones((m,)), p0=100.0), *map(j, args), ref_kal.KalmanConfig(**cfg)
    )
    state, traj = kal.run_kalman(
        kal.kalman_init(m, x0=torch.ones(m), p0=100.0), *map(t, args), kal.KalmanConfig(**cfg)
    )
    _assert_state(state, ref_state)
    assert_scaled(traj, ref_traj)


def test_kalman_gram_path_and_fleet(rng):
    """precompute_step_inputs + kalman_step_gram / run_kalman_fleet(_gram)
    against the reference (the fleet forms vmapped there, batched here)."""
    b, s = 3, 6
    steps = [_stability_steps(rng, s, 8, 5) for _ in range(b)]
    c, w, a, ls, lq = (np.stack([st[k] for st in steps]) for k in range(5))
    cfg, ref_cfg = kal.KalmanConfig(), ref_kal.KalmanConfig()
    ref_inp = ref_kal.precompute_step_inputs(*map(j, (c, w, a, ls, lq)), ref_cfg)
    inp = kal.precompute_step_inputs(*map(t, (c, w, a, ls, lq)), cfg)
    for name, p, r in zip(kal.KalmanStepInputs._fields, inp, ref_inp):
        assert_scaled(p, r, what=name)
    x0 = np.abs(rng.standard_normal((b, 5))).astype(np.float32) * 10
    ref_states = ref_kal.KalmanState(*(jnp.stack(z) for z in zip(*[ref_kal.kalman_init(5, x0=j(x)) for x in x0])))
    states = kal.kalman_init(5, x0=t(x0))
    one_ref = ref_kal.kalman_step_gram(
        ref_kal.kalman_init(5, x0=j(x0[0])), ref_kal.KalmanStepInputs(*(l[0, 0] for l in ref_inp)), ref_cfg
    )
    one = kal.kalman_step_gram(
        kal.kalman_init(5, x0=t(x0[0])), kal.KalmanStepInputs(*(l[0, 0] for l in inp)), cfg
    )
    _assert_state(one[0], one_ref[0], "step_gram")
    for ref_run, run, args, ref_args in (
        (ref_kal.run_kalman_fleet_gram, kal.run_kalman_fleet_gram, (inp,), (ref_inp,)),
        (ref_kal.run_kalman_fleet, kal.run_kalman_fleet,
         tuple(map(t, (c, w, a, ls, lq))), tuple(map(j, (c, w, a, ls, lq)))),
    ):
        ref_final, ref_traj = ref_run(ref_states, *ref_args, ref_cfg)
        final, traj = run(states, *args, cfg)
        _assert_state(final, ref_final, run.__name__)
        assert_scaled(traj, ref_traj, what=run.__name__)
    ref_final, ref_traj = ref_kal.run_kalman_gram(
        ref_kal.kalman_init(5, x0=j(x0[1])), ref_kal.KalmanStepInputs(*(l[1] for l in ref_inp)), ref_cfg
    )
    final, traj = kal.run_kalman_gram(
        kal.kalman_init(5, x0=t(x0[1])), kal.KalmanStepInputs(*(l[1] for l in inp)), cfg
    )
    _assert_state(final, ref_final, "run_kalman_gram")
    assert_scaled(traj, ref_traj)


def test_latency_welford_and_variance(rng):
    m = 2
    ref_state, state = ref_kal.kalman_init(m), kal.kalman_init(m, device="cpu")
    lats = rng.uniform(0.5, 2.0, size=50).astype(np.float32)
    for chunk in np.split(lats, 5):
        args = (
            np.zeros((4, m), np.float32), np.zeros(4, np.float32),
            np.array([len(chunk), 0.0], np.float32),
            np.array([chunk.sum(), 0.0], np.float32),
            np.array([(chunk**2).sum(), 0.0], np.float32),
        )
        ref_state, _ = ref_kal.kalman_step(ref_state, *map(j, args))
        state, _ = kal.kalman_step(state, *map(t, args))
    _assert_state(state, ref_state)
    assert_scaled(kal.latency_variance(state), ref_kal.latency_variance(ref_state))


# ---------------------------------------------------------- shapley/footprints


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spectrum_axioms_and_reference(seed):
    rng = np.random.default_rng(seed)
    b, m = 3, 6
    x = (np.abs(rng.standard_normal((b, m))) * 20).astype(np.float32)
    lat = (np.abs(rng.standard_normal((b, m))) + 0.1).astype(np.float32)
    inv = rng.integers(0, 5, (b, m)).astype(np.float32)
    inv[:, 2] = 0.0  # a null player on every node
    cp = (rng.random(b) * 500).astype(np.float32)
    idle = (rng.random(b) * 5000).astype(np.float32)
    spec = fp.assemble_spectrum(t(x), t(lat), t(inv), t(cp), t(idle))
    for i in range(b):
        ref = ref_fp.assemble_spectrum(j(x[i]), j(lat[i]), j(inv[i]), jnp.float32(cp[i]), jnp.float32(idle[i]))
        for name, p, r in zip(fp.FootprintSpectrum._fields, spec, ref):
            assert_scaled(p[i], r, what=name)
    # Efficiency, null player, Eq. 4 (linearity).
    np.testing.assert_allclose(spec.phi_cp.sum(-1).numpy(), cp, rtol=1e-5)
    np.testing.assert_allclose(spec.phi_idle.sum(-1).numpy(), idle, rtol=1e-5)
    assert torch.all(spec.j_total[:, 2] == 0.0)
    torch.testing.assert_close(spec.j_total, spec.j_indiv + spec.phi_cp + spec.phi_idle, rtol=0, atol=0)
    # Symmetry: identical functions get identical shares.
    inv2 = inv.copy()
    inv2[:, 4] = inv2[:, 3]
    x2 = x.copy()
    x2[:, 4] = x2[:, 3]
    lat2 = lat.copy()
    lat2[:, 4] = lat2[:, 3]
    sym = fp.assemble_spectrum(t(x2), t(lat2), t(inv2), t(cp), t(idle))
    torch.testing.assert_close(sym.j_total[:, 3], sym.j_total[:, 4], rtol=0, atol=0)
    # The individual Shapley pieces against the reference, one node.
    assert_scaled(shap.shapley_idle_share(t(idle[0]), t(inv[0]) > 0), ref_shap.shapley_idle_share(jnp.float32(idle[0]), j(inv[0]) > 0))
    assert_scaled(
        shap.shapley_control_plane_share(t(cp[0]), t(inv[0])),
        ref_shap.shapley_control_plane_share(jnp.float32(cp[0]), j(inv[0])),
    )


def test_metrics_match_reference(rng):
    a = (np.abs(rng.standard_normal(20)) + 0.5).astype(np.float32)
    b = (np.abs(rng.standard_normal(20)) + 0.5).astype(np.float32)
    samples = np.abs(rng.standard_normal((7, 4))).astype(np.float32)
    for port, ref in (
        (met.individual_difference(t(a), t(b)), ref_met.individual_difference(j(a), j(b))),
        (met.cosine_similarity(t(a), t(b)), ref_met.cosine_similarity(j(a), j(b))),
        (met.total_power_error(t(a), t(b)), ref_met.total_power_error(j(a), j(b))),
        (met.latency_normalized_variance(t(a), t(b)), ref_met.latency_normalized_variance(j(a), j(b))),
        (met.coefficient_of_variation(t(samples)), ref_met.coefficient_of_variation(j(samples))),
    ):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5)
    assert met.marginal_energy(10.0, 4.0, 3) == ref_met.marginal_energy(10.0, 4.0, 3)
