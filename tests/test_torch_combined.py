"""Port vs reference: combined mode (§4.3), the CPU power model, and the
deterministic trace statistics of the batched path.

Mirrors ``tests/test_combined_fleet.py`` and the combined cases of
``tests/test_hetero_fleet.py``: both packages get the same seeded NumPy
traces and telemetry (the port's simulator is a bitwise copy), then each
profiles them through its own per-node ``profile``, ``fleet_profile_batched``,
streaming session and control plane.  Tolerances:

- the reference's own between its paths: ``_assert_reports_close`` (rtol
  1e-5 / atol 1e-4 on ``x_power``, rtol 1e-4 / atol 1e-2 on ``j_total``,
  Total-Error to 1e-4), counters to rtol 1e-6;
- port against reference: estimates as ``max|port - ref| <= tol *
  max(1, max|ref|)`` (ROADMAP.md), tol 1e-5;
- ``fit_ridge``: see ``test_fit_ridge_batched_matches_per_node``.

Every port call passes ``device="cpu"``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpu_model as ref_cpumod
from repro.core.profiler import FaasMeterProfiler as RefProfiler
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.core.profiler import fleet_profile_batched as ref_fleet_profile_batched
from repro.core.profiler import prepare_combined_fleet as ref_prepare
from repro.serving.control_plane import EnergyFirstControlPlane as RefControlPlane
from repro.telemetry import counters as ref_counters
from repro.telemetry.simulator import NodeSimulator as RefSimulator
from repro.telemetry.simulator import SimulatorConfig as RefSimConfig
from repro.workload.azure import WorkloadConfig as RefWorkloadConfig
from repro.workload.azure import generate_trace as ref_generate_trace
from repro.workload.functions import paper_functions as ref_paper_functions
from repro_torch.core import contribution as contrib
from repro_torch.core import cpu_model as cpumod
from repro_torch.core.engine import (
    EngineConfig,
    combined_rest_target,
    fleet_rest_idle,
    run_fleet,
    synthetic_fleet,
)
from repro_torch.core.profiler import (
    FaasMeterProfiler,
    ProfilerConfig,
    Telemetry,
    fleet_profile_batched,
    prepare_combined_fleet,
)
from repro_torch.core.sessions.report import _per_fn_latency_stats
from repro_torch.serving import EnergyFirstControlPlane
from repro_torch.telemetry.counters import function_counters, window_counters
from repro_torch.telemetry.simulator import NodeSimulator, SimulatorConfig
from repro_torch.workload.functions import paper_functions

#: sync_max_shift=0 pins every path's skew to 0.0, as the reference suite
#: does, so the streaming session's init-window skew estimate stays out of
#: the cross-path pins.
SMALL = dict(init_windows=60, step_windows=30, mode="combined", sync_max_shift=0)
PCFG = ProfilerConfig(**SMALL)
M = 7


def _scaled(port, ref, tol=1e-5):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    err = float(np.max(np.abs(port.astype(np.float64) - ref), initial=0.0))
    return err <= tol * max(1.0, float(np.abs(ref).max(initial=0.0)))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_reports_close(got, want, *, atol=1e-4, tag=""):
    """The reference suite's pin between two paths (one package)."""
    np.testing.assert_allclose(_np(got.x_power), _np(want.x_power), rtol=1e-5, atol=atol, err_msg=f"{tag} x_power")
    assert got.total_error == pytest.approx(want.total_error, abs=1e-4), tag
    np.testing.assert_allclose(
        _np(got.spectrum.j_total), _np(want.spectrum.j_total), rtol=1e-4, atol=1e-2, err_msg=f"{tag} j_total"
    )
    assert got.idle_energy == pytest.approx(want.idle_energy, rel=1e-5), tag


def _assert_port_matches_ref(port, ref, tag=""):
    """Port report against the reference's: estimates at 1e-5 of scale."""
    for name in ("x_power", "x_trajectory", "x_cp", "invocations", "mean_latency"):
        assert _scaled(getattr(port, name), getattr(ref, name)), (tag, name)
    for name in ("j_indiv", "j_total"):
        assert _scaled(getattr(port.spectrum, name), getattr(ref.spectrum, name)), (tag, name)
    assert port.total_error == pytest.approx(ref.total_error, rel=1e-4, abs=1e-5), tag
    assert port.idle_energy == pytest.approx(ref.idle_energy, rel=1e-5), tag
    assert port.skew_windows == ref.skew_windows, tag


def _specs(reg):
    specs = reg.specs
    return dict(
        gflops=np.asarray([s.gflops for s in specs]),
        hbm_gb=np.asarray([s.hbm_gb for s in specs]),
        mean_latency=np.asarray([max(s.mean_latency_s, 1e-3) for s in specs]),
    )


def _fleet(b=2, durations=None, platforms=None, platform="desktop"):
    """Reference traces (numpy) and both packages' telemetry of them, plus
    both packages' combined inputs."""
    durations = [150.0] * b if durations is None else durations
    reg = ref_paper_functions()
    traces = [
        ref_generate_trace(reg, RefWorkloadConfig(duration_s=d, load=1.0, seed=1 + i))
        for i, d in enumerate(durations)
    ]
    seeds = [11 + i for i in range(b)]
    ref_tels = [
        s.telemetry
        for s in RefSimulator(reg, RefSimConfig(platform=platform)).simulate_fleet(traces, seeds=seeds, platforms=platforms)
    ]
    tels = [
        s.telemetry
        for s in NodeSimulator(paper_functions(), SimulatorConfig(platform=platform)).simulate_fleet(
            traces, seeds=seeds, platforms=platforms
        )
    ]
    arrays = [(t.fn_id, t.start, t.end) for t in traces]
    ref_arrays = [tuple(jnp.asarray(x) for x in a) for a in arrays]
    duration = durations if len(set(durations)) > 1 else durations[0]
    ref_in = ref_prepare(RefProfilerConfig(**SMALL), ref_arrays, ref_tels, num_fns=M, duration=duration, **_specs(reg))
    port_in = prepare_combined_fleet(PCFG, arrays, tels, num_fns=M, duration=duration, device="cpu", **_specs(reg))
    return dict(arrays=arrays, ref_arrays=ref_arrays, tels=tels, ref_tels=ref_tels,
                durations=durations, duration=duration, ref_in=ref_in, port_in=port_in)


def _solo(profiler, fl, ref=False):
    fnc, _, models = fl["ref_in"] if ref else fl["port_in"]
    rows = ref_cpumod.model_row if ref else cpumod.model_row
    arrays, tels = (fl["ref_arrays"], fl["ref_tels"]) if ref else (fl["arrays"], fl["tels"])
    kw = {} if ref else dict(device="cpu")
    return [
        profiler.profile(
            *arrays[i], num_fns=M, duration=fl["durations"][i], telemetry=tels[i],
            fn_counters=fnc[i], counter_model=rows(models, i), **kw,
        )
        for i in range(len(arrays))
    ]


def _batched(profiler, fl, ref=False):
    fnc, _, models = fl["ref_in"] if ref else fl["port_in"]
    if ref:
        return ref_fleet_profile_batched(
            profiler, fl["ref_arrays"], fl["ref_tels"], num_fns=M, duration=fl["duration"],
            fn_counters=fnc, counter_model=models,
        )
    return fleet_profile_batched(
        profiler, fl["arrays"], fl["tels"], num_fns=M, duration=fl["duration"],
        fn_counters=fnc, counter_model=models, device="cpu",
    )


def _session(profiler, fl, ref=False, **kw):
    fnc, wf, models = fl["ref_in"] if ref else fl["port_in"]
    tels = fl["ref_tels"] if ref else fl["tels"]
    if not ref:
        kw.setdefault("device", "cpu")
    sess = profiler.start_fleet_stream(
        fl["ref_arrays"] if ref else fl["arrays"], num_fns=M, duration=fl["duration"],
        idle_watts=[t.idle_watts for t in tels],
        has_chip=[t.chip_power is not None for t in tels],
        has_cp=tels[0].cp_cpu_frac is not None,
        fn_counters=fnc, counter_model=models, window_features=wf, **kw,
    )

    def col(v, t):
        if v is None:
            return 0.0
        arr = np.asarray(v)
        return arr[t] if t < arr.shape[0] else 0.0

    for t in range(int(round(max(fl["durations"])))):
        sess.push_window(
            w_sys=np.asarray([col(x.system_power, t) for x in tels]),
            w_chip=np.asarray([col(x.chip_power, t) for x in tels]),
            cp_frac=np.asarray([col(x.cp_cpu_frac, t) for x in tels]),
            sys_frac=np.asarray([col(x.sys_cpu_frac, t) for x in tels]),
        )
    return sess, sess.finalize()


# ---------------------------------------------------------------------------
# Deterministic trace statistics (the batched path's card sums).
# ---------------------------------------------------------------------------


def _old_contribution(fn_id, start, end, num_fns, num_windows):
    """The index_add_ formulation the port used before (per-chunk segment sum
    then one add), written out here as the oracle."""
    edges = torch.arange(num_windows + 1, dtype=torch.float32)
    pad = (-fn_id.shape[0]) % 1024
    fn_id = torch.cat([fn_id, fn_id.new_full((pad,), -1)])
    start = torch.cat([start, start.new_zeros(pad)])
    end = torch.cat([end, end.new_zeros(pad)])
    acc = torch.zeros((num_fns + 1, num_windows + 1))
    for lo in range(0, fn_id.shape[0], 1024):
        cid, cs = fn_id[lo : lo + 1024], start[lo : lo + 1024]
        dur = torch.clamp(end[lo : lo + 1024] - cs, min=0.0)
        f = torch.minimum(torch.clamp(edges[None, :] - cs[:, None], min=0.0), dur[:, None])
        f = f * (cid >= 0).to(f.dtype)[:, None]
        acc = acc + torch.zeros_like(acc).index_add_(0, torch.where(cid >= 0, cid, num_fns), f)
    cum = acc[:num_fns]
    return (cum[:, 1:] - cum[:, :-1]).T


def test_trace_statistics_give_the_old_index_add_sums():
    """The host reduction that replaced the card's atomic ``index_add_`` is
    the old CPU formulation: contribution matrix, per-step statistics and
    per-function latency moments equal it bitwise (tolerance 0), and two
    batched profiles of one fleet give the same bits."""
    tr = ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=1800.0, load=1.0, seed=58))
    fn_id = torch.as_tensor(tr.fn_id, dtype=torch.int64)
    start, end = torch.as_tensor(tr.start), torch.as_tensor(tr.end)
    c = contrib.contribution_matrix(fn_id, start, end, num_fns=M, num_windows=1800)
    assert torch.equal(c, _old_contribution(fn_id, start, end, M, 1800))

    dur = torch.clamp(end - start, min=0.0)
    valid = fn_id >= 0
    seg = torch.where(valid, fn_id, M)
    old = [torch.zeros(M + 1).index_add_(0, seg, v)[:M] for v in (valid.float(), torch.where(valid, dur, 0.0))]
    counts, mean, lat_sum, _ = _per_fn_latency_stats(fn_id, start, end, M)
    assert torch.equal(counts, old[0]) and torch.equal(lat_sum, old[1])

    step_idx = torch.floor((start - 100.0) / 60.0).to(torch.int64)
    ok = valid & (step_idx >= 0) & (step_idx < 28)
    seg = torch.where(ok, step_idx * M + torch.clamp(fn_id, 0, M - 1), 28 * M)
    old_ls = torch.zeros(28 * M + 1).index_add_(0, seg, torch.where(ok, dur, 0.0))[:-1].reshape(28, M)
    a_steps, lat_sums, _ = FaasMeterProfiler()._per_step_stats(fn_id, start, end, M, M + 1, 100, 28)
    assert torch.equal(lat_sums[:, :M], old_ls) and a_steps.shape == (28, M + 1)

    fl = _fleet(b=3)
    pure = FaasMeterProfiler(ProfilerConfig(init_windows=60, step_windows=30))
    runs = [
        fleet_profile_batched(pure, fl["arrays"], fl["tels"], num_fns=M, duration=150.0, device="cpu")
        for _ in range(2)
    ]
    for a, b in zip(*runs):
        assert torch.equal(a.x_power, b.x_power) and torch.equal(a.x_trajectory, b.x_trajectory)


def test_invocation_counts_are_exact_integers():
    """``invocation_counts`` sums ones (exact in float32 below 2^24), so its
    order — and CUDA's atomic adds — cannot change a bit: every entry is an
    integer and the total is the number of in-range invocations."""
    tr = ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=600.0, load=3.0, seed=4))
    a = contrib.invocation_counts(
        torch.as_tensor(tr.fn_id, dtype=torch.int64), torch.as_tensor(tr.start), num_fns=M, num_windows=600
    )
    assert torch.equal(a, torch.round(a))
    assert int(a.sum()) == int(((tr.fn_id >= 0) & (tr.start < 600.0)).sum())


# ---------------------------------------------------------------------------
# The CPU power model.
# ---------------------------------------------------------------------------


def test_fit_ridge_survives_badly_scaled_counters():
    """The standardized solve fits GFLOP/s-scale counters to ~1e-4 relative
    (the reference's regression bound, 2e-4), on the reference's data."""
    rng = np.random.default_rng(0)
    n = 120
    busy = rng.random(n) * 0.9
    gflop = busy * 46800.0 + rng.random(n) * 500.0
    hbm = busy * 160.0 + rng.random(n) * 3.0
    x = np.stack([gflop, hbm, busy], axis=1)
    y = x @ np.array([0.001, 0.2, 55.0]) + 40.0
    xt, yt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    pred = cpumod.predict_power(cpumod.fit_ridge(xt, yt), xt).numpy()
    assert float(np.max(np.abs(pred - y) / y)) < 2e-4


def test_fit_ridge_batched_matches_per_node():
    """The oracle is the *per-node* fit, on the reference test's data
    (features scaled ~1e3, 40 and 0.5).

    - Against the port's own per-node fit the batched one is exact.
    - Against the reference's per-node fit: predictions, bias and the
      weights of the two large features at rtol 1e-4.  The weight of the
      0.5-scaled feature is fixed by float32 rounding only to ~1e-3 here:
      its share of the power (~0.04 W of ~1e3 W) is at the level of the
      normal equations' float32 noise.  The reference's own per-node fit
      lies 9.0e-4 (relative) from the float64 solve of the same
      standardized system at node 0, and its two forms 1.8e-4 apart (the
      known reference failure); no float32 summation order reproduces its
      bits.  That weight is held at rtol 2e-3, and the port's model at the
      reference's bound otherwise (error signal < 0.01, flags).
    - A gap to the reference's *batched* (vmapped) form is not a port
      fault and is not checked.
    """
    rng = np.random.default_rng(1)
    x = np.abs(rng.standard_normal((3, 50, 3))) * np.array([1e3, 40.0, 0.5])
    w = np.abs(rng.standard_normal((3, 3))) + 0.1
    y = np.einsum("bnf,bf->bn", x, w) + 25.0
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    xb, yb = torch.from_numpy(x32), torch.from_numpy(y32)
    mb = cpumod.fit_ridge(xb, yb)
    assert mb.weights.shape == (3, 3) and mb.bias.shape == (3,)
    for i in range(3):
        mine = cpumod.model_row(mb, i)
        own = cpumod.fit_ridge(xb[i], yb[i])
        torch.testing.assert_close(mine.weights, own.weights, rtol=1e-6, atol=0)
        torch.testing.assert_close(mine.bias, own.bias, rtol=1e-6, atol=0)
        ref = ref_cpumod.fit_ridge(jnp.asarray(x32[i]), jnp.asarray(y32[i]))
        np.testing.assert_allclose(mine.weights.numpy()[:2], np.asarray(ref.weights)[:2], rtol=1e-4)
        np.testing.assert_allclose(mine.weights.numpy()[2], np.asarray(ref.weights)[2], rtol=2e-3)
        np.testing.assert_allclose(float(mine.bias), float(ref.bias), rtol=1e-4)
        np.testing.assert_allclose(
            cpumod.predict_power(mine, xb[i]).numpy(),
            np.asarray(ref_cpumod.predict_power(ref, jnp.asarray(x32[i]))),
            rtol=1e-4,
        )
    err = cpumod.model_error(mb, xb, yb)
    assert err.shape == (3,) and float(err.max()) < 0.01
    assert not bool(cpumod.retrain_flags(mb, xb, yb).any())
    assert bool(cpumod.retrain_flags(mb, xb, yb * 1.5).all())


def test_fit_ridge_mask_degenerates_to_zero_model():
    """An all-masked node gets the zero model (the chipless fit), and a
    partly masked node the fit of its live rows, as in the reference."""
    rng = np.random.default_rng(6)
    x = np.abs(rng.standard_normal((2, 40, 3))).astype(np.float32) * np.float32(10.0)
    y = (x @ np.array([1.0, 2.0, 3.0], np.float32) + 5.0).astype(np.float32)
    mask = np.ones((2, 40), np.float32)
    mask[0] = 0.0
    mask[1, 30:] = 0.0
    m = cpumod.fit_ridge(torch.from_numpy(x), torch.from_numpy(y), mask=torch.from_numpy(mask))
    r = ref_cpumod.fit_ridge(jnp.asarray(x), jnp.asarray(y), mask=jnp.asarray(mask))
    assert float(m.weights[0].abs().max()) == 0.0 and float(m.bias[0]) == 0.0
    assert _scaled(m.weights, r.weights, 1e-4) and _scaled(m.bias, r.bias, 1e-4)


def test_batched_svr_matches_sequential():
    """The batched subgradient loop reproduces the per-node
    ``fit_linear_svr`` (the reference's pin: rtol 1e-5, atol 1e-6), and
    the reference's fit at 1e-4 of scale: 20,000 subgradient steps carry
    last-bit differences of the two frameworks' products along."""
    rng = np.random.default_rng(2)
    b, n, f = 3, 80, 3
    x = np.abs(rng.standard_normal((b, n, f))).astype(np.float32)
    w = np.abs(rng.standard_normal((b, f))).astype(np.float32) + 0.1
    y = (np.einsum("bnf,bf->bn", x, w) + 30.0 + 0.1 * rng.standard_normal((b, n))).astype(np.float32)
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    mb = cpumod.fit_linear_svr(xb, yb)
    assert mb.weights.shape == (b, f) and mb.bias.shape == (b,)
    ref = ref_cpumod.fit_linear_svr(jnp.asarray(x), jnp.asarray(y))
    assert _scaled(mb.weights, ref.weights, 1e-4) and _scaled(mb.bias, ref.bias, 1e-4)
    for i in range(b):
        mi = cpumod.fit_linear_svr(xb[i], yb[i])
        torch.testing.assert_close(cpumod.model_row(mb, i).weights, mi.weights, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(cpumod.model_row(mb, i).bias, mi.bias, rtol=1e-5, atol=1e-6)


def test_idle_interval_bias_is_routed_not_dropped():
    """With sum(fn_active_frac) ~ 0 the static chip power comes back as the
    residual; the chip-side split conserves the model total either way,
    and every output equals the reference's."""
    m = cpumod.LinearPowerModel(torch.tensor([10.0, 5.0]), torch.tensor(7.0))
    rm = ref_cpumod.LinearPowerModel(jnp.asarray([10.0, 5.0]), jnp.asarray(7.0))
    fn_feats = np.asarray([[0.6, 0.2], [0.4, 0.8]], np.float32)
    for frac in (np.asarray([0.5, 0.5], np.float32), np.zeros(2, np.float32)):
        feats = fn_feats if frac.any() else np.zeros_like(fn_feats)
        per_fn, resid = cpumod.predict_function_power_split(m, torch.from_numpy(feats), torch.from_numpy(frac))
        r_fn, r_resid = ref_cpumod.predict_function_power_split(rm, jnp.asarray(feats), jnp.asarray(frac))
        np.testing.assert_array_equal(per_fn.numpy(), np.asarray(r_fn))
        assert float(resid) == float(r_resid)
        total = float(cpumod.predict_power(m, torch.from_numpy(feats).sum(dim=0)))
        assert float(per_fn.sum() + resid) == pytest.approx(total, rel=1e-5)
    assert float(resid) == pytest.approx(7.0)
    mb = cpumod.stack_models([m, m])
    pf, rs = cpumod.predict_function_power_split(
        mb, torch.from_numpy(np.stack([fn_feats, np.zeros_like(fn_feats)])), torch.tensor([[0.5, 0.5], [0.0, 0.0]])
    )
    np.testing.assert_allclose(rs.numpy(), [0.0, 7.0], atol=1e-6)
    assert float(pf[1].sum()) == 0.0


def test_merge_models_swaps_flagged_rows():
    old = cpumod.LinearPowerModel(torch.zeros(3, 2), torch.zeros(3))
    new = cpumod.LinearPowerModel(torch.ones(3, 2), torch.ones(3))
    got = cpumod.merge_models(old, new, np.asarray([True, False, True]))
    assert got.weights.tolist() == [[1.0, 1.0], [0.0, 0.0], [1.0, 1.0]]
    assert got.bias.tolist() == [1.0, 0.0, 1.0]


def test_idle_segment_report_conserves_chip_bias():
    """An idle segment through the combined profiler: the un-attributed
    static chip bias lands in the report's idle energy."""
    profiler = FaasMeterProfiler(PCFG)
    n = 120
    rng = np.random.default_rng(3)
    tel = Telemetry(
        system_power=torch.as_tensor(80.0 + 0.1 * rng.random(n), dtype=torch.float32),
        chip_power=torch.as_tensor(30.0 + 0.1 * rng.random(n), dtype=torch.float32),
        idle_watts=78.0, cp_cpu_frac=None, sys_cpu_frac=None,
    )
    model = cpumod.LinearPowerModel(torch.tensor([1.0, 1.0, 1.0]), torch.tensor(12.5))
    report = profiler.profile(
        np.asarray([-1], np.int32), np.zeros(1, np.float32), np.zeros(1, np.float32),
        num_fns=3, duration=float(n), telemetry=tel,
        fn_counters=torch.zeros(3, 3), counter_model=model, device="cpu",
    )
    assert float(report.x_power.abs().max()) == pytest.approx(0.0, abs=1e-6)
    assert report.idle_energy == pytest.approx((78.0 + 12.5) * n)


def test_rest_idle_ignores_telemetry_past_the_segment():
    """Chip telemetry longer than the profiled segment (with a lower floor
    in the tail) changes neither the combined target nor the report."""
    profiler = FaasMeterProfiler(PCFG)
    rng = np.random.default_rng(4)
    n = 100
    base_chip = 40.0 + 5.0 * rng.random(n + 60).astype(np.float32)
    sys_p = 120.0 + 10.0 * rng.random(n + 60).astype(np.float32)
    fn_id = np.zeros(40, np.int32)
    start = np.linspace(1.0, 90.0, 40).astype(np.float32)

    def report_for(chip_tail):
        chip = base_chip.copy()
        chip[n:] = chip_tail
        tel = Telemetry(torch.from_numpy(sys_p), torch.from_numpy(chip), 95.0, None, None)
        return profiler.profile(
            fn_id, start, start + np.float32(1.5), num_fns=2, duration=float(n), telemetry=tel,
            fn_counters=torch.from_numpy(np.eye(2, 3, dtype=np.float32)),
            counter_model=cpumod.LinearPowerModel(torch.tensor([1.0, 1.0, 1.0]), torch.tensor(5.0)),
            device="cpu",
        )

    hi, lo = report_for(60.0), report_for(1.0)
    assert torch.equal(hi.x_power, lo.x_power) and hi.total_error == lo.total_error


def test_rest_idle_stays_a_tensor():
    """``_rest_idle`` and the combined target stay tensors on the
    telemetry's device (no host read): 100 - 30 - (80 - 30)."""
    profiler = FaasMeterProfiler(PCFG)
    tel = Telemetry(torch.full((50,), 100.0), torch.full((50,), 30.0), 80.0, None, None)
    rest = profiler._rest_idle(tel, 50)
    assert isinstance(rest, torch.Tensor) and float(rest) == 50.0
    out = profiler._target_signal(torch.full((50,), 100.0), tel, 50)
    torch.testing.assert_close(out, torch.full((50,), 20.0))


# ---------------------------------------------------------------------------
# Fleet-shaped counters.
# ---------------------------------------------------------------------------


def test_counters_fleet_shape_match_reference_and_mask_junk():
    rng = np.random.default_rng(5)
    b, n, m = 4, 30, 5
    c = rng.random((b, n, m))
    gf = np.abs(rng.standard_normal(m)) + 0.5
    hb = np.abs(rng.standard_normal(m)) * 0.2
    lat = np.abs(rng.standard_normal(m)) + 0.1
    ct = torch.as_tensor(c, dtype=torch.float32)
    wf, fc = window_counters(ct, gf, hb, lat, 1.0), function_counters(ct, gf, hb, lat)
    assert wf.shape == (b, n, 3) and fc.shape == (b, m, 3)
    np.testing.assert_allclose(wf.numpy(), np.asarray(ref_counters.window_counters(c, gf, hb, lat, 1.0)), rtol=1e-6)
    np.testing.assert_allclose(fc.numpy(), np.asarray(ref_counters.function_counters(c, gf, hb, lat)), rtol=1e-6)
    for i in range(b):
        torch.testing.assert_close(wf[i], window_counters(ct[i], gf, hb, lat, 1.0), rtol=1e-6, atol=0)
        torch.testing.assert_close(fc[i].sum(dim=0), torch.ones(3), rtol=1e-5, atol=0)
    lengths = [n, 12, 20, 7]
    junk = c.copy()
    mask = np.zeros((b, n), np.float32)
    for i, li in enumerate(lengths):
        junk[i, li:] = 777.0
        mask[i, :li] = 1.0
    jt = torch.as_tensor(junk, dtype=torch.float32)
    wf_m = window_counters(jt, gf, hb, lat, 1.0, mask=torch.from_numpy(mask))
    fc_m = function_counters(jt, gf, hb, lat, mask=torch.from_numpy(mask))
    for i, li in enumerate(lengths):
        if li < n:
            assert float(wf_m[i, li:].abs().max()) == 0.0
        torch.testing.assert_close(fc_m[i], function_counters(ct[i, :li], gf, hb, lat), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Engine-level and report-level conservation.
# ---------------------------------------------------------------------------


def test_combined_target_conserves_per_tick():
    """Attributed + unattributed == the combined target on every tick, and
    target + chip + rest_idle reconstructs the system power where the
    clamp is inactive."""
    b, s, n_w, m = 3, 3, 10, 6
    inputs = synthetic_fleet(b, s, n_w, m, seed=7, density=0.3, device="cpu")
    rng = np.random.default_rng(8)
    chip = torch.as_tensor(35.0 + 5.0 * rng.random((b, s * n_w)), dtype=torch.float32)
    idle = torch.tensor([90.0, 85.0, 95.0])
    rest_idle = fleet_rest_idle(chip[:, :20], idle)
    torch.testing.assert_close(rest_idle, torch.clamp(idle - chip[:, :20].amin(dim=1), min=0.0))
    w_sys = inputs.w.reshape(b, -1) + chip + rest_idle[:, None]
    target = combined_rest_target(w_sys, chip, rest_idle[:, None])
    torch.testing.assert_close(target + chip + rest_idle[:, None], w_sys, rtol=1e-6, atol=0)
    torch.testing.assert_close(target, inputs.w.reshape(b, -1), rtol=0, atol=1e-4)
    out = run_fleet(inputs._replace(w=target.reshape(b, s, n_w)), EngineConfig(), device="cpu")
    recon = out.tick_power.sum(-1) + out.unattributed
    torch.testing.assert_close(recon, target, rtol=0, atol=1e-3)


def test_combined_report_conserves_energy_per_window():
    fl = _fleet(b=1)
    solo = _solo(FaasMeterProfiler(PCFG), fl)[0]
    assert solo.total_error < 0.3
    total = float(solo.spectrum.j_indiv.sum()) + solo.cp_energy + solo.idle_energy
    assert abs(float(solo.spectrum.j_total.sum()) - total) / total <= 1e-5


# ---------------------------------------------------------------------------
# Combined inputs, and the paths against each other and the reference.
# ---------------------------------------------------------------------------


def test_prepare_combined_fleet_matches_reference():
    """Counters at rtol 1e-6; the fitted models at the reference's spread
    between its own fit forms (1e-4 of scale)."""
    fl = _fleet(b=3, durations=[150.0, 100.0, 125.0])
    (rf, rw, rm), (pf, pw, pm) = fl["ref_in"], fl["port_in"]
    np.testing.assert_allclose(pf.numpy(), np.asarray(rf), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-6, atol=1e-6)
    assert _scaled(pm.weights, rm.weights, 1e-4) and _scaled(pm.bias, rm.bias, 1e-4)


def test_combined_batched_matches_oracle_and_reference():
    fl = _fleet(b=3)
    solo = _solo(FaasMeterProfiler(PCFG), fl)
    batched = _batched(FaasMeterProfiler(PCFG), fl)
    ref = _batched(RefProfiler(RefProfilerConfig(**SMALL)), fl, ref=True)
    for i, (rb, rs, rr) in enumerate(zip(batched, solo, ref)):
        _assert_reports_close(rb, rs, tag=f"node {i} batched-vs-oracle")
        _assert_port_matches_ref(rb, rr, tag=f"node {i} batched-vs-reference")


def test_combined_streaming_matches_batched_and_reference():
    """The session sees the batched path's targets (skew 0, rest idle from
    the same init block): engine tolerance against it, the reference
    session's reports and per-step model errors at 1e-5 of scale."""
    fl = _fleet(b=2)
    batched = _batched(FaasMeterProfiler(PCFG), fl)
    solo = _solo(FaasMeterProfiler(PCFG), fl)
    sess, streamed = _session(FaasMeterProfiler(PCFG), fl)
    ref_sess, ref_streamed = _session(RefProfiler(RefProfilerConfig(**SMALL)), fl, ref=True)
    for i in range(2):
        np.testing.assert_allclose(
            streamed[i].x_power.numpy(), batched[i].x_power.numpy(), rtol=1e-5, atol=1e-5
        )
        assert streamed[i].total_error == pytest.approx(batched[i].total_error, abs=1e-5)
        _assert_reports_close(streamed[i], solo[i], tag=f"node {i} stream-vs-oracle")
        _assert_port_matches_ref(streamed[i], ref_streamed[i], tag=f"node {i} stream-vs-reference")
    assert len(sess.model_errors) == len(ref_sess.model_errors) == 3
    assert _scaled(np.stack(sess.model_errors), np.stack(ref_sess.model_errors))
    np.testing.assert_array_equal(sess.retrain_needed, ref_sess.retrain_needed)
    assert _scaled(sess.x_cpu, ref_sess.x_cpu)


def test_combined_ragged_fleet_matches_per_node():
    """Per-node durations, including a node with zero post-init steps."""
    fl = _fleet(b=3, durations=[150.0, 100.0, 65.0])
    solo = _solo(FaasMeterProfiler(PCFG), fl)
    batched = _batched(FaasMeterProfiler(PCFG), fl)
    _, streamed = _session(FaasMeterProfiler(PCFG), fl)
    ref = _batched(RefProfiler(RefProfilerConfig(**SMALL)), fl, ref=True)
    assert solo[2].x_trajectory.shape[0] == 1
    for i in range(3):
        _assert_reports_close(batched[i], solo[i], tag=f"ragged node {i} batched")
        _assert_reports_close(streamed[i], solo[i], tag=f"ragged node {i} stream")
        _assert_port_matches_ref(batched[i], ref[i], tag=f"ragged node {i} reference")
        assert batched[i].x_trajectory.shape == solo[i].x_trajectory.shape


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_mixed_fleet_matches_per_platform_batches(ragged):
    """A server/desktop/edge batch reproduces each node's single-platform
    result on the per-node, batched and streaming paths; the chipless edge
    node's rows equal the pure path's, inside the combined batch."""
    platforms = ["server", "desktop", "edge"]
    fl = _fleet(b=3, durations=[180.0, 150.0, 150.0] if ragged else None, platforms=platforms)
    profiler = FaasMeterProfiler(PCFG)
    pure = FaasMeterProfiler(dataclasses.replace(PCFG, mode="pure"))
    refs = []
    for i, plat in enumerate(platforms):
        d = fl["durations"][i]
        (tel_i,) = [
            s.telemetry
            for s in NodeSimulator(paper_functions(), SimulatorConfig(platform=plat)).simulate_fleet(
                [ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=d, load=1.0, seed=1 + i))],
                seeds=[11 + i],
            )
        ]
        assert torch.equal(tel_i.system_power, fl["tels"][i].system_power), plat
        if tel_i.chip_power is None:
            refs += fleet_profile_batched(pure, [fl["arrays"][i]], [tel_i], num_fns=M, duration=d, device="cpu")
            continue
        fnc, _, models = prepare_combined_fleet(
            PCFG, [fl["arrays"][i]], [tel_i], num_fns=M, duration=d, device="cpu", **_specs(ref_paper_functions())
        )
        refs += fleet_profile_batched(
            profiler, [fl["arrays"][i]], [tel_i], num_fns=M, duration=d,
            fn_counters=fnc, counter_model=models, device="cpu",
        )
    batched = _batched(profiler, fl)
    oracle = _solo(profiler, fl)
    _, streamed = _session(profiler, fl)
    ref_batched = _batched(RefProfiler(RefProfilerConfig(**SMALL)), fl, ref=True)
    for i, plat in enumerate(platforms):
        _assert_reports_close(batched[i], refs[i], tag=f"batched:{plat}")
        _assert_reports_close(oracle[i], refs[i], tag=f"oracle:{plat}")
        _assert_reports_close(streamed[i], refs[i], tag=f"stream:{plat}")
        _assert_port_matches_ref(batched[i], ref_batched[i], tag=f"reference:{plat}")
    # The chipless row is the pure path's, exactly as data.
    torch.testing.assert_close(batched[2].x_power, refs[2].x_power, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Streaming retrain plumbing.
# ---------------------------------------------------------------------------


def test_streaming_retrain_signal_plumbing():
    """Each node's model is scored at every step boundary, on the host: a
    healthy model stays un-flagged under a loose threshold, a model with a
    50 W bias error flags every node; the errors equal the reference's."""
    fl = _fleet(b=2)
    fnc, wf, models = fl["port_in"]

    def run(model, threshold, ref=False):
        cfgs = dict(retrain_config=(ref_cpumod if ref else cpumod).CpuModelConfig(retrain_threshold=threshold))
        inputs = dict(fl)
        key = "ref_in" if ref else "port_in"
        inputs[key] = (inputs[key][0], inputs[key][1], model)
        prof = RefProfiler(RefProfilerConfig(**SMALL)) if ref else FaasMeterProfiler(PCFG)
        return _session(prof, inputs, ref=ref, **cfgs)[0]

    healthy = run(models, 0.25)
    assert len(healthy.model_errors) == 3 and not healthy.retrain_needed.any()
    assert float(np.stack(healthy.model_errors).max()) < 0.25
    broken = cpumod.LinearPowerModel(models.weights, models.bias + 50.0)
    drifted = run(broken, 0.05)
    assert drifted.retrain_needed.all() and all(e.shape == (2,) for e in drifted.model_errors)
    rm = fl["ref_in"][2]
    ref_drifted = run(ref_cpumod.LinearPowerModel(rm.weights, rm.bias + 50.0), 0.05, ref=True)
    assert _scaled(np.stack(drifted.model_errors), np.stack(ref_drifted.model_errors))


def test_refit_writes_models_in_place():
    """A refit merges the flagged rows into the session's own model and
    ``x_cpu`` tensors: their storage never moves, the unflagged row keeps
    its bits, and the refit model equals the reference session's at the
    reference's spread between fit forms (1e-4 of scale)."""
    fl = _fleet(b=2)
    fnc, wf, models = fl["port_in"]
    broken = cpumod.LinearPowerModel(models.weights, models.bias + torch.tensor([50.0, 0.0]))
    sess, _ = _session(FaasMeterProfiler(PCFG), dict(fl, port_in=(fnc, wf, broken)))
    rm = fl["ref_in"][2]
    ref_broken = ref_cpumod.LinearPowerModel(rm.weights, rm.bias + jnp.asarray([50.0, 0.0]))
    ref_sess, _ = _session(
        RefProfiler(RefProfilerConfig(**SMALL)), dict(fl, ref_in=(fl["ref_in"][0], fl["ref_in"][1], ref_broken)), ref=True
    )
    assert sess.retrain_needed[0] and ref_sess.retrain_needed[0]
    ptrs = [sess._models.weights.data_ptr(), sess._models.bias.data_ptr(), sess.x_cpu.data_ptr()]
    kept = (sess._models.weights[1].clone(), sess._models.bias[1].clone(), sess.x_cpu[1].clone())
    flags = sess.refit_counter_models(np.asarray([True, False]))
    np.testing.assert_array_equal(flags, ref_sess.refit_counter_models(np.asarray([True, False])))
    assert flags.tolist() == [True, False] and not sess.retrain_needed[0]
    assert ptrs == [sess._models.weights.data_ptr(), sess._models.bias.data_ptr(), sess.x_cpu.data_ptr()]
    assert torch.equal(sess._models.weights[1], kept[0]) and torch.equal(sess._models.bias[1], kept[1])
    assert torch.equal(sess.x_cpu[1], kept[2])
    assert sess.refits[-1][0] == ref_sess.refits[-1][0] == 150
    assert abs(float(sess._models.bias[0]) - float(models.bias[0])) < 10.0  # the 50 W error is gone
    assert _scaled(sess._models.bias, ref_sess._models.bias, 1e-4)
    assert _scaled(sess._models_host.weights, ref_sess._models.weights, 1e-4)
    assert _scaled(sess.x_cpu, ref_sess.x_cpu, 1e-4)
    assert not sess.refit_counter_models(np.asarray([False, False])).any()


def test_session_rejects_missing_combined_inputs():
    fl = _fleet(b=2)
    kw = dict(num_fns=M, duration=150.0, idle_watts=[t.idle_watts for t in fl["tels"]], has_cp=True, device="cpu")
    with pytest.raises(ValueError, match="fn_counters"):
        FaasMeterProfiler(PCFG).start_fleet_stream(fl["arrays"], has_chip=True, **kw)
    with pytest.raises(ValueError, match="chip"):
        FaasMeterProfiler(PCFG).start_fleet_stream(
            fl["arrays"], has_chip=False, fn_counters=fl["port_in"][0], counter_model=fl["port_in"][2], **kw
        )


# ---------------------------------------------------------------------------
# Control plane end to end.
# ---------------------------------------------------------------------------


def _planes(platform="desktop"):
    cfg = dict(SMALL, mode="pure")  # combined via mode= override
    return (
        RefControlPlane(ref_paper_functions(), RefSimConfig(platform=platform, seed=0), RefProfilerConfig(**cfg)),
        EnergyFirstControlPlane(
            paper_functions(), SimulatorConfig(platform=platform, seed=0), ProfilerConfig(**cfg), device="cpu"
        ),
    )


def test_control_plane_combined_matches_reference():
    """``profile_fleet(mode='combined')``: reports, live trackers (the full
    chip + rest spectrum) and prices at 1e-5 of scale against the
    reference's; the tick hook sees every engine tick."""
    ref_cp, cp = _planes()
    traces = [ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=150.0, load=1.0, seed=s)) for s in (3, 4)]
    seen = []
    out = cp.profile_fleet(traces, seeds=[21, 22], mode="combined", on_tick=lambda tk, trs: seen.append(tk.t))
    ref = ref_cp.profile_fleet(traces, seeds=[21, 22], mode="combined", mesh=None)
    assert seen == list(range(60, 150))
    for p, r in zip(out, ref):
        _assert_port_matches_ref(p.report, r.report)
        tp, tr = p.footprint_stream, r.footprint_stream
        assert tp.ticks_seen == tr.ticks_seen == 90
        for name in ("j_indiv", "per_invocation_total", "invocations"):
            assert _scaled(getattr(tp, name), getattr(tr, name)), name
        for k, v in r.prices.items():
            assert _scaled(p.prices[k], v), k


def test_control_plane_combined_rejects_chipless_platform():
    _, cp = _planes(platform="edge")
    traces = [ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=150.0, load=1.0, seed=1))]
    with pytest.raises(ValueError, match="chip"):
        cp.profile_fleet(traces, seeds=[5], mode="combined")


def test_control_plane_pure_mode_unchanged_by_default():
    _, cp = _planes()
    traces = [ref_generate_trace(ref_paper_functions(), RefWorkloadConfig(duration_s=150.0, load=1.0, seed=9))]
    default = cp.profile_fleet(traces, seeds=[7])
    explicit = cp.profile_fleet(traces, seeds=[7], mode="pure")
    assert torch.equal(default[0].report.x_power, explicit[0].report.x_power)
