"""Port vs reference: the int8 KV cache (``kernels/ref.py::quantize_kv`` and
``decode_attention_quant``, the int8 branch of ``attention_decode``, the
int8 prefill and decode of the decoder stack) on the reduced granite-3-8b
config, as the reference's own ``tests/test_perf_features.py`` pins it.

``quantize_kv`` is pinned bitwise on inputs both packages hold in the same
bits.  Where the rows come out of fp32 products that the two frameworks sum
in other orders (an ulp apart), an int8 value may land one step over a
rounding boundary: those are counted, must be one step, and must be few.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.kernels import ref as r_ref
from repro.models import attention as r_attn
from repro.models import build as r_build
from repro.models.common import materialize as r_materialize
from repro.models.model_zoo import extend_cache as r_extend_cache
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import build, extend_cache

B, S = 2, 64


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


def int8_close(got, want, max_frac=1e-3):
    """An int8 cache equal but for a few values one step apart; bf16 scales
    equal but for as few values one bf16 step (2^-7 of the value) apart."""
    step = 1.0 if got.dtype == torch.int8 else 2.0**-7 * np.abs(np.asarray(want, np.float32))
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert np.all(diff <= step), float(np.max(diff))
    assert np.count_nonzero(diff) <= max_frac * diff.size, np.count_nonzero(diff)


def test_quantize_kv_bitwise_and_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 4, 16)) * rng.uniform(0.01, 10, (2, 8, 4, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    x[0, 1, 0, :4] = [127.0, 63.5, -0.5, 2.5]  # ties at x / scale = 63.5, -0.5, 2.5: half to even
    q_r, s_r = r_ref.quantize_kv(jnp.asarray(x))
    q_t, s_t = t_ref.quantize_kv(torch.tensor(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_r, np.float32))
    # the reference's own round-trip bound (tests/test_perf_features.py)
    back = q_t.float() * s_t.float()[..., None]
    bound = float(s_t.float().max()) * 0.51 + 0.01 * float(np.abs(x).max())
    assert float((back - torch.tensor(x)).abs().max()) <= bound
    # bf16 input: the same bits in both packages
    xb = jnp.asarray(x, jnp.bfloat16)
    q_r, s_r = r_ref.quantize_kv(xb)
    q_t, s_t = t_ref.quantize_kv(torch.tensor(np.asarray(xb, np.float32)).bfloat16())
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_r, np.float32))


@pytest.mark.parametrize("h,hkv,lengths", [(4, 2, (64, 17)), (8, 8, (1, 40)), (6, 1, (33, 33))])
def test_decode_attention_quant_matches(h, hkv, lengths):
    rng = np.random.default_rng(h)
    b, s, d = len(lengths), 64, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8) for _ in range(2))
    ks, vs = (np.asarray(jnp.asarray(rng.uniform(0.001, 0.05, (b, s, hkv)), jnp.bfloat16), np.float32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    want = r_ref.decode_attention_quant(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                                        jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16), jnp.asarray(lens))
    got = t_ref.decode_attention_quant(torch.tensor(q), torch.tensor(kq), torch.tensor(vq),
                                       torch.tensor(ks).bfloat16(), torch.tensor(vs).bfloat16(), torch.tensor(lens))
    close(got, want)


@pytest.fixture(scope="module")
def granite():
    """fp32-compute granite (reduced) with the bf16-typed and the int8 cache,
    the reference's parameters in both packages, seeded prompts."""
    rcfg = dataclasses.replace(r_get_config("granite-3-8b", reduced=True), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("granite-3-8b", reduced=True), compute_dtype="float32")
    rq, tq = (dataclasses.replace(c, kv_cache_dtype="int8") for c in (rcfg, tcfg))
    r_params = r_materialize(r_build(rcfg).params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    return rcfg, tcfg, rq, tq, r_params, t_params, toks, tok


def test_attention_decode_int8_branch_matches(granite):
    rcfg, tcfg, rq, tq, r_params, t_params, toks, tok = granite
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kv_shape = (B, S + 4, tcfg.num_kv_heads, tcfg.head_dim)
    kq, vq = (rng.integers(-127, 128, kv_shape).astype(np.int8) for _ in range(2))
    ks, vs = (np.asarray(jnp.asarray(rng.uniform(0.001, 0.05, kv_shape[:-1]), jnp.bfloat16), np.float32)
              for _ in range(2))
    p_r = jax.tree.map(lambda a: a[0], r_params["layers"])["attn"]
    y_r, kq_r, vq_r, (ks_r, vs_r) = r_attn.attention_decode(
        p_r, jnp.asarray(x), jnp.asarray(S, jnp.int32), jnp.asarray(kq), jnp.asarray(vq), rq,
        kv_scales=(jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16)))
    caches = [torch.tensor(a) for a in (kq, vq)] + [torch.tensor(a).bfloat16() for a in (ks, vs)]
    y_t, kq_t, vq_t, (ks_t, vs_t) = t_attn.attention_decode(
        t_params["layers"][0]["attn"], torch.tensor(x), S, caches[0], caches[1], tq, kv_scales=(caches[2], caches[3]))
    assert kq_t is caches[0] and ks_t is caches[2]  # written in place
    close(y_t, y_r)
    for got, want in ((kq_t, kq_r), (vq_t, vq_r), (ks_t, ks_r), (vs_t, vs_r)):
        int8_close(got, want)


def test_int8_prefill_and_decode_match_reference(granite):
    rcfg, tcfg, rq, tq, r_params, t_params, toks, tok = granite
    r_api, t_api = r_build(rq), build(tq)
    lg_r, c_r = jax.jit(r_api.prefill)(r_params, {"tokens": jnp.asarray(toks)})
    lg_t, c_t = t_api.prefill(t_params, {"tokens": torch.tensor(toks)})
    close(lg_t, lg_r)
    assert set(c_t) == set(c_r) == {"k", "v", "k_scale", "v_scale"}
    for name in c_r:
        int8_close(c_t[name], c_r[name])
    c_r, c_t = r_extend_cache(r_api, c_r, 4), extend_cache(t_api, c_t, 4)
    assert all(tuple(c_t[n].shape) == tuple(c_r[n].shape) for n in c_r)
    decode = jax.jit(r_api.decode)
    for i in range(3):
        lg_r, c_r = decode(r_params, c_r, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        lg_t, c_t = t_api.decode(t_params, c_t, torch.tensor(tok), S + i)
        close(lg_t, lg_r)
        tok = np.asarray(lg_r[:, -1].argmax(-1), np.int32)[:, None]
    for name in c_r:
        int8_close(c_t[name], c_r[name])


def test_decode_accuracy_vs_bf16_cache(granite):
    """The reference's pins on the port: int8-cache decode logits against
    the unquantized cache's, cosine > 0.999 and argmax equal."""
    rcfg, tcfg, rq, tq, r_params, t_params, toks, tok = granite
    api, api_q = build(tcfg), build(tq)
    _, cache = api.prefill(t_params, {"tokens": torch.tensor(toks)})
    _, cache_q = api_q.prefill(t_params, {"tokens": torch.tensor(toks)})
    cache, cache_q = extend_cache(api, cache, 4), extend_cache(api_q, cache_q, 4)
    d1, _ = api.decode(t_params, cache, torch.tensor(tok), S)
    d2, _ = api_q.decode(t_params, cache_q, torch.tensor(tok), S)
    cos = float((d1 * d2).sum() / (d1.norm() * d2.norm()))
    assert cos > 0.999, cos
    assert torch.equal(d1[:, -1].argmax(-1), d2[:, -1].argmax(-1))


def test_int8_cache_spec_matches_prefill(granite):
    rcfg, tcfg, rq, tq, r_params, t_params, toks, tok = granite
    shape = ShapeConfig("s", S, B, "prefill")
    _, cache = build(tq).prefill(t_params, {"tokens": torch.tensor(toks)})
    spec = build(tq).cache_spec(shape)
    assert cache["k"].dtype == torch.int8 and set(cache) == set(spec)
    for name, sp in spec.items():
        assert (tuple(cache[name].shape), cache[name].dtype) == (sp.shape, sp.dtype), name
    from repro.configs.shapes import ShapeConfig as RefShape

    r_spec = r_build(rq).cache_spec(RefShape("s", S, B, "prefill"))
    assert {n: s.shape for n, s in spec.items()} == {n: tuple(s.shape) for n, s in r_spec.items()}
