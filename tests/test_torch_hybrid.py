"""Port vs reference: the Mamba2 block and the Zamba2 hybrid stack, and
the plain attention at zamba2's head_dim 112.

The reduced zamba2 config (5 layers, the shared attention block at layers
0, 2 and 4) in fp32; the reference's parameters come over with
``convert.params_from_numpy`` and the same seeded numpy inputs go through
both packages.  Values are pinned at ``max|port - ref| <= 1e-5 *
max(1, max|ref|)`` (``tests/test_torch_models.py``'s rule); the serving
invariant at the reference's own 2e-3 / 5e-3 (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RefShape
from repro.kernels import ref as r_ref
from repro.models import build as r_build
from repro.models import model_zoo as r_zoo
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tf
from repro.models.common import materialize as r_materialize
from repro.serving.kv_cache import init_cache as r_init_cache
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as t_ref
from repro_torch.models import build, extend_cache
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.models.common import keeps_fp32, materialize
from repro_torch.serving import kv_cache as t_kv

B, S = 2, 21  # S not a multiple of the reduced chunk (16): a ragged SSD tail


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


@pytest.fixture(scope="module")
def zamba():
    rcfg = dataclasses.replace(r_get_config("zamba2-7b", reduced=True), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("zamba2-7b", reduced=True), compute_dtype="float32")
    r_api, t_api = r_build(rcfg), build(tcfg)
    r_params = r_materialize(r_api.params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    rng = np.random.default_rng(7)
    # Random SSM leaves, so that the decay, step bias and skip are not the
    # init's zeros and ones.
    r_params = jax.tree.map(lambda a: a, r_params)
    for name, lo, hi in (("a_log", -1.0, 0.5), ("dt_bias", -0.5, 0.5), ("d_skip", 0.5, 1.5),
                         ("conv_b", -0.1, 0.1), ("gamma_gate", 0.8, 1.2)):
        arr = rng.uniform(lo, hi, size=r_params["layers"]["mamba"][name].shape).astype(np.float32)
        r_params["layers"]["mamba"][name] = jnp.asarray(arr)
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    tokens = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, size=(3, B, 1)).astype(np.int32)
    return dict(rcfg=rcfg, tcfg=tcfg, r_api=r_api, t_api=t_api, r_params=r_params, t_params=t_params,
                tokens=tokens, steps=steps, rng=rng)


def _mamba(f, which, layer=1):
    if which == "ref":
        return jax.tree.map(lambda a: a[layer], f["r_params"]["layers"]["mamba"])
    return f["t_params"]["layers"][layer]["mamba"]


def _x(f, s, seed):
    return np.random.default_rng(seed).standard_normal((B, s, f["tcfg"].d_model)).astype(np.float32)


@pytest.mark.parametrize("with_tail", [False, True])
def test_conv1d_with_and_without_tail(zamba, with_tail):
    f = zamba
    di, k = f["tcfg"].d_inner, f["tcfg"].ssm_conv
    rng = np.random.default_rng(3)
    xin = rng.standard_normal((B, 5, di)).astype(np.float32)
    tail = rng.standard_normal((B, k - 1, di)).astype(np.float32) if with_tail else None
    rp, tp = _mamba(f, "ref"), _mamba(f, "port")
    y_r, tail_r = r_ssm._conv1d(jnp.asarray(xin), rp["conv_w"], rp["conv_b"],
                                None if tail is None else jnp.asarray(tail))
    y_t, tail_t = t_ssm._conv1d(torch.tensor(xin), tp["conv_w"], tp["conv_b"],
                                None if tail is None else torch.tensor(tail))
    close(y_t, y_r)
    close(tail_t, tail_r)
    np.testing.assert_array_equal(tail_t.numpy(), np.concatenate(
        [np.zeros((B, k - 1, di), np.float32) if tail is None else tail, xin], axis=1)[:, -(k - 1):])


@pytest.mark.parametrize("s", [32, 21])  # a chunk multiple, and a ragged tail
def test_mamba_apply_matches(zamba, s):
    f = zamba
    x = _x(f, s, s)
    y_r, (h_r, tail_r) = r_ssm.mamba_apply(_mamba(f, "ref"), jnp.asarray(x), f["rcfg"], return_state=True)
    y_t, (h_t, tail_t) = t_ssm.mamba_apply(_mamba(f, "port"), torch.tensor(x), f["tcfg"], return_state=True)
    close(y_t, y_r)
    close(h_t, h_r)
    close(tail_t, tail_r)
    assert h_t.dtype == torch.float32
    # Continuing from the returned state equals running the whole sequence.
    x2 = _x(f, 5, 99)
    y2_r = r_ssm.mamba_apply(_mamba(f, "ref"), jnp.asarray(x2), f["rcfg"], state=(h_r, tail_r))
    y2_t = t_ssm.mamba_apply(_mamba(f, "port"), torch.tensor(x2), f["tcfg"], state=(h_t, tail_t))
    close(y2_t, y2_r)
    whole = t_ssm.mamba_apply(_mamba(f, "port"), torch.tensor(np.concatenate([x, x2], axis=1)), f["tcfg"])
    close(y2_t, whole[:, s:].numpy())


def test_mamba_decode_matches_and_updates_in_place(zamba):
    f = zamba
    cfg = f["tcfg"]
    x = _x(f, 12, 5)
    _, (h_r, tail_r) = r_ssm.mamba_apply(_mamba(f, "ref"), jnp.asarray(x), f["rcfg"], return_state=True)
    _, (h_t, tail_t) = t_ssm.mamba_apply(_mamba(f, "port"), torch.tensor(x), cfg, return_state=True)
    h_t, tail_t = h_t.clone(), tail_t.clone()
    for i in range(3):
        x1 = _x(f, 1, 40 + i)
        y_r, h_r, tail_r = r_ssm.mamba_decode(_mamba(f, "ref"), jnp.asarray(x1), h_r, tail_r, f["rcfg"])
        ptr = (h_t.data_ptr(), tail_t.data_ptr())
        y_t, h_out, tail_out = t_ssm.mamba_decode(_mamba(f, "port"), torch.tensor(x1), h_t, tail_t, cfg)
        assert h_out is h_t and tail_out is tail_t and (h_t.data_ptr(), tail_t.data_ptr()) == ptr
        close(y_t, y_r)
        close(h_t, h_r)
        close(tail_t, tail_r)


def test_mamba_leaves_the_reference_reads_in_fp32_stay_fp32(zamba):
    """At bf16 compute the decay, step bias, skip and gate norm stay fp32
    (the reference casts them up), every other weight is bf16."""
    api = build(get_config("zamba2-7b", reduced=True))
    params = materialize(api.params_def, torch.Generator().manual_seed(0), torch.bfloat16)
    m = params["layers"][2]["mamba"]
    for name in ("a_log", "dt_bias", "d_skip", "gamma_gate"):
        assert keeps_fp32(name) and m[name].dtype == torch.float32, name
    for name in ("w_zx", "w_bc", "w_dt", "conv_w", "conv_b", "w_out"):
        assert m[name].dtype == torch.bfloat16, name
    assert params["layers"][0]["ln"].dtype == torch.float32 and "shared" in params
    assert params["shared"]["attn"]["wq"].dtype == torch.bfloat16


def test_hybrid_train_matches(zamba):
    f = zamba
    logits_r, _ = r_tf.hybrid_train(f["r_params"], jnp.asarray(f["tokens"]), f["rcfg"])
    logits_t, aux = t_tf.hybrid_train(f["t_params"], torch.tensor(f["tokens"]), f["tcfg"])
    close(logits_t, logits_r)
    assert float(aux) == 0.0


def test_hybrid_prefill_and_decode_match_at_every_application_point(zamba):
    """The per-point KV cache (points 0, 1, 2 = layers 0, 2, 4), the SSM
    states and conv tails after prefill and after each decode step."""
    f = zamba
    assert t_tf.n_attn_points(f["tcfg"]) == r_tf._n_attn_points(f["rcfg"]) == 3
    lg_r, c_r = jax.jit(f["r_api"].prefill)(f["r_params"], {"tokens": jnp.asarray(f["tokens"])})
    lg_t, c_t = f["t_api"].prefill(f["t_params"], {"tokens": torch.tensor(f["tokens"])})
    close(lg_t, lg_r)
    assert set(c_t) == set(c_r) == {"attn_k", "attn_v", "ssm_h", "conv"}
    for name in c_r:
        close(c_t[name], c_r[name])
    c_r, c_t = r_zoo.extend_cache(f["r_api"], c_r, 4), extend_cache(f["t_api"], c_t, 4)
    decode = jax.jit(f["r_api"].decode)
    for i, tok in enumerate(f["steps"]):
        lg_r, c_r = decode(f["r_params"], c_r, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        lg_t, c_t = f["t_api"].decode(f["t_params"], c_t, torch.tensor(tok), S + i)
        close(lg_t, lg_r)
        for name in c_r:
            close(c_t[name], c_r[name])
    # The row written at the last step lives at point 2 (layer 4) too.
    assert float(c_t["attn_k"][2, :, S + 2].abs().sum()) > 0
    assert float(c_t["attn_k"][2, :, S + 3].abs().sum()) == 0


def test_hybrid_prefill_decode_consistency(zamba):
    """The reference's serving invariant on the port: prefill's last logits
    equal the full forward's at 2e-3, one decode step the full forward over
    the extended prompt at 5e-3."""
    f = zamba
    tokens = f["tokens"]
    logits_pf, cache = f["t_api"].prefill(f["t_params"], {"tokens": torch.tensor(tokens)})
    full, _ = t_tf.hybrid_train(f["t_params"], torch.tensor(tokens), f["tcfg"])
    np.testing.assert_allclose(logits_pf[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)
    cache = extend_cache(f["t_api"], cache, 4)
    tok = f["steps"][0]
    logits_dec, _ = f["t_api"].decode(f["t_params"], cache, torch.tensor(tok), S)
    full2, _ = t_tf.hybrid_train(f["t_params"], torch.tensor(np.concatenate([tokens, tok], axis=1)), f["tcfg"])
    np.testing.assert_allclose(logits_dec[:, 0].numpy(), full2[:, -1].numpy(), atol=5e-3, rtol=5e-3)


def test_hybrid_cache_spec_init_and_growth_match_the_reference(zamba):
    f = zamba
    shape, rshape = ShapeConfig("s", S, B, "prefill"), RefShape("s", S, B, "prefill")
    spec, r_spec = f["t_api"].cache_spec(shape), f["r_api"].cache_spec(rshape)
    assert {n: sp.shape for n, sp in spec.items()} == {n: tuple(sp.shape) for n, sp in r_spec.items()}
    assert spec["ssm_h"].dtype == torch.float32 and spec["conv"].dtype == torch.float32
    _, cache = f["t_api"].prefill(f["t_params"], {"tokens": torch.tensor(f["tokens"])})
    for name, sp in spec.items():
        assert (tuple(cache[name].shape), cache[name].dtype) == (sp.shape, sp.dtype), name
    fresh, r_fresh = t_kv.init_cache(f["t_api"], shape, device="cpu"), r_init_cache(f["r_api"], rshape)
    for name in spec:
        np.testing.assert_array_equal(fresh[name].numpy(), np.asarray(r_fresh[name], np.float32))
    assert t_kv.cache_bytes(f["t_api"], shape) == sum(
        int(np.prod(sp.shape)) * np.dtype(sp.dtype).itemsize for sp in r_spec.values())
    grown = extend_cache(f["t_api"], cache, 5)
    r_grown = r_zoo.extend_cache(f["r_api"], jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in cache.items()}), 5)
    for name in cache:
        assert tuple(grown[name].shape) == tuple(r_grown[name].shape), name
    assert grown["ssm_h"] is cache["ssm_h"] and grown["conv"] is cache["conv"]


def test_hybrid_bf16_cache_at_full_width_spec():
    """zamba2-7b's serving caches at chat's shape: 14 application points of
    32 x 112 K and V in bf16, 81 layers of fp32 SSM state."""
    api = build(get_config("zamba2-7b"))
    spec = api.cache_spec(ShapeConfig("chat", 576, 8, "prefill"))
    assert spec["attn_k"].shape == (14, 8, 576, 32, 112) and spec["attn_k"].dtype == torch.bfloat16
    assert spec["ssm_h"].shape == (81, 8, 112, 64, 64) and spec["ssm_h"].dtype == torch.float32
    assert spec["conv"].shape == (81, 8, 3, 7168)
    assert t_kv.cache_bytes(api, ShapeConfig("chat", 576, 8, "prefill")) == (
        2 * 14 * 8 * 576 * 32 * 112 * 2 + 81 * 8 * 112 * 64 * 64 * 4 + 81 * 8 * 3 * 7168 * 2)


# ---------------------------------------------------------------------------
# Attention at head_dim 112: the plain versions against the reference's,
# and the kernels' plans.
# ---------------------------------------------------------------------------


# The reference's blocked version takes block multiples only.
@pytest.mark.parametrize("b,s,t,causal", [(2, 48, 48, True), (1, 32, 64, True), (2, 32, 64, False)])
def test_plain_flash_at_head_dim_112(b, s, t, causal):
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((b, s, 32, 112)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, 32, 112)).astype(np.float32) for _ in range(2))
    want = r_ref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 16, 16)
    got = t_ref.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal, 16, 16)
    close(got, want)


def test_plain_decode_at_head_dim_112():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 32, 112)).astype(np.float32)
    k, v = (rng.standard_normal((3, 50, 32, 112)).astype(np.float32) for _ in range(2))
    lens = np.array([50, 1, 23], np.int32)
    want = r_ref.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    got = t_ref.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(lens))
    close(got, want)


def test_kernels_take_head_dim_112_natively():
    """d 112 is a head_dim of both kernels: bf16 flash on the tensor-core
    kernel (its plan: ``test_flash_tc_plan``), decode with 16 lanes per
    bf16 key (14 busy) and tiles of whole warp steps."""
    assert 112 in fa.HEAD_DIMS and 112 in fa.TC_HEAD_DIMS and 112 in da.HEAD_DIMS
    assert fa.variant(torch.bfloat16, 112) == "tc" and fa.variant(torch.float32, 112) == "fma"
    assert (da.key_lanes(112, 2), da.tile_keys(112, 2)) == (16, 32)
    assert (da.key_lanes(112, 4), da.tile_keys(112, 4)) == (32, 16)
    for d in (16, 32, 64, 128):  # the power-of-two head dims keep their tiles
        for elem in (2, 4):
            assert da.tile_keys(d, elem) == min(da.MAX_TILE, da.STAGE_TARGET // (2 * d * elem))
    chat = da.decode_plan(8, 32, 32, 576, 112, 2, 132)
    assert chat["cluster"] == 1 and chat["smem_bytes"] <= 232448
    q = torch.zeros(1, 4, 32, 112, dtype=torch.bfloat16)
    assert fa.check_args(q, q, q) == "tc"
