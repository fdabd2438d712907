"""Port vs reference: the serving slice (engine, metered server, pricing,
launcher) on the reduced internlm2 config.

Greedy tokens are pinned equal in fp32 compute: both packages run the same
weights (carried over with ``convert.params_from_numpy``) on the same
prompts.  Pricing is pinned at float32 rounding (rtol 1e-6) on the same
numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.internlm2_1_8b import REDUCED as REF_REDUCED
from repro.configs.shapes import ShapeConfig as RefShape
from repro.core import pricing as r_pricing
from repro.models import build as r_build
from repro.models.common import materialize as r_materialize
from repro.serving import kv_cache as r_kv
from repro.serving.engine import ServeEngine as RefEngine
from repro_torch.configs.internlm2_1_8b import REDUCED
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import pricing as t_pricing
from repro_torch.launch import serve as t_serve
from repro_torch.models import build
from repro_torch.models.common import materialize
from repro_torch.serving import kv_cache as t_kv
from repro_torch.serving.control_plane import MeteredServer
from repro_torch.serving.engine import ServeEngine

B, S, STEPS = 2, 16, 4


@pytest.fixture(scope="module")
def fp32_pair():
    rcfg = dataclasses.replace(REF_REDUCED, compute_dtype="float32")
    tcfg = dataclasses.replace(REDUCED, compute_dtype="float32")
    r_api, t_api = r_build(rcfg), build(tcfg)
    r_params = r_materialize(r_api.params_def, jax.random.PRNGKey(3))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    return r_api, t_api, r_params, t_params


def test_generate_tokens_equal_reference(fp32_pair):
    r_api, t_api, r_params, t_params = fp32_pair
    tokens = np.random.default_rng(5).integers(0, REDUCED.vocab_size, size=(B, S)).astype(np.int32)
    want = RefEngine(r_api, RefShape("serve", S, B, "prefill"), r_params).generate(
        {"tokens": jnp.asarray(tokens)}, STEPS
    )
    engine = ServeEngine(t_api, ShapeConfig("serve", S, B, "prefill"), t_params)
    got = engine.generate({"tokens": torch.tensor(tokens)}, STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rec = engine.records[-1]
    assert rec.kind == "generate" and rec.tokens == B * STEPS and rec.latency >= 0.0
    # decode_step and fresh_cache: the engine's single-step surface
    logits, cache = engine.prefill({"tokens": torch.tensor(tokens)})
    cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], dim=2) for k, v in cache.items()}
    _, cache = engine.decode_step(cache, got[:, :1], S)
    assert [r.kind for r in engine.records[-2:]] == ["prefill", "decode"]
    fresh = engine.fresh_cache()
    assert set(fresh) == {"k", "v"} and float(fresh["k"].abs().sum()) == 0.0
    assert fresh["k"].shape == (REDUCED.num_layers, B, S, REDUCED.num_kv_heads, REDUCED.head_dim)


def test_cache_and_param_bytes_equal_reference():
    shape, rshape = ShapeConfig("s", 64, 3, "prefill"), RefShape("s", 64, 3, "prefill")
    assert t_kv.cache_bytes(build(REDUCED), shape) == r_kv.cache_bytes(r_build(REF_REDUCED), rshape)
    assert t_kv.params_bytes(build(REDUCED)) == r_kv.params_bytes(r_build(REF_REDUCED))
    cache = t_kv.init_cache(build(REDUCED), shape, device="cpu")
    assert cache["k"].dtype == torch.bfloat16 and cache["v"].shape == (2, 3, 64, 2, 16)


def test_metered_server_trace_is_well_formed():
    """Two function classes on one set of weights, served 2:1."""
    api = build(REDUCED)
    params = materialize(api.params_def, torch.Generator().manual_seed(0), torch.bfloat16)
    rng = np.random.default_rng(0)
    server = MeteredServer()
    classes = {"chat": (ShapeConfig("chat", 12, 3, "prefill"), 4), "summarize": (ShapeConfig("sum", 40, 1, "prefill"), 2)}
    for name, (shape, steps) in classes.items():
        server.register(name, ServeEngine(api, shape, params), t_serve.random_batch(api, shape, rng, "cpu"), steps=steps)
    schedule = [("chat", 0.0), ("chat", 0.0), ("summarize", 0.0)] * 2
    trace = server.serve(schedule, duration=5.0)
    assert trace.fn_names == ["chat", "summarize"] and trace.num_fns == 2
    np.testing.assert_array_equal(trace.fn_id, [0, 0, 1, 0, 0, 1])
    assert np.all(np.diff(trace.start) >= 0) and np.all(trace.end >= trace.start)
    assert np.all(trace.start[1:] >= trace.end[:-1])  # back to back
    assert trace.duration >= max(5.0, float(trace.end[-1])) and trace.duration == np.ceil(trace.duration)
    for name, (shape, steps) in classes.items():
        engine = server.functions[name][0]
        assert not engine.cold
        served = sum(1 for fn, _ in schedule if fn == name)
        assert [r.tokens for r in engine.records] == [shape.global_batch * steps] * served


def test_price_report_equals_reference():
    rng = np.random.default_rng(0)
    j_indiv = rng.random(5).astype(np.float32) * 1e4
    j_total = j_indiv + rng.random(5).astype(np.float32) * 1e3
    inv = np.array([0, 3, 10, 1, 7], np.float32)
    lat = rng.random(5).astype(np.float32)
    mem = rng.random(5).astype(np.float32) * 2
    cfg = r_pricing.PricingConfig(usd_per_kwh=0.2, carbon_intensity_g_per_kwh=300.0)
    want = r_pricing.price_report(*(jnp.asarray(x) for x in (j_indiv, j_total, inv, lat, mem)), cfg)
    got = t_pricing.price_report(
        *(torch.tensor(x) for x in (j_indiv, j_total, inv, lat, mem)),
        t_pricing.PricingConfig(usd_per_kwh=0.2, carbon_intensity_g_per_kwh=300.0),
    )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_live_price_meter_equals_reference():
    rng = np.random.default_rng(1)
    r_meter, t_meter = r_pricing.LivePriceMeter(3), t_pricing.LivePriceMeter(3)
    for _ in range(20):
        power = rng.random(4) * 50  # 3 functions + a shared principal
        starts = rng.integers(0, 2, size=4)
        starts[2] = 0  # function 2 never invoked: no idle share
        for m in (r_meter, t_meter):
            m.observe_tick(power, starts, 0.5, idle_watts=30.0)
    np.testing.assert_array_equal(t_meter.j_total, r_meter.j_total)
    assert t_meter.j_total[2] == t_meter.j_indiv[2]
    lat, mem = np.array([0.1, 0.2, 0.3]), np.ones(3)
    want, got = r_meter.report(lat, mem), t_meter.report(lat, mem)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_serve_main_end_to_end_on_cpu(capsys):
    t_serve.main(["--requests", "4", "--seq", "16", "--gen-steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "skipped" not in out
    assert "xlstm-350m/generate registered" in out
    assert "internlm2-1.8b/generate registered" in out
    assert "== serving 4 requests ==" in out
    for name in ("internlm2-1.8b", "xlstm-350m"):  # 4 requests round-robin reach both
        line = next(ln for ln in out.splitlines() if f"{name}/generate " in ln and "J/inv=" in ln)
        assert "usd/inv=" in line and "carbon g/inv=" in line
    assert "total-error=" in out


def test_serve_defaults_to_the_card():
    """Without a card the launcher refuses the default device instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve.main(["--requests", "1"])
