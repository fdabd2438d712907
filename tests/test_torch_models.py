"""Port vs reference: the dense model-zoo path (internlm2, reduced config).

The reference's parameter tree (``materialize`` with ``PRNGKey(0)``) is
carried over with ``convert.params_from_numpy``; the same tokens and
activations, made with numpy, go through both packages.  On the CPU both
route attention to their plain versions (the reference's blocked jnp
oracle, the port's ``kernels/ref.py``).

Tolerances: fp32 compute is pinned at ``max|port - ref| <= 1e-5 *
max(1, max|ref|)``, the port's cross-framework rule (ROADMAP): the two
frameworks take the same fp32 sums in other orders.  bf16 compute is
pinned on the logits at 6 bf16 steps at the logits' scale (2^-8 * 6 *
max(1, max|ref|)): the two frameworks round the bf16 activations of each
product and norm at other places, and two layers compound that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.internlm2_1_8b import REDUCED as REF_REDUCED
from repro.models import attention as r_attn
from repro.models import build as r_build
from repro.models import mlp as r_mlp
from repro.models import transformer as r_tf
from repro.models.common import materialize as r_materialize
from repro.models.model_zoo import extend_cache as r_extend_cache
from repro_torch.configs.internlm2_1_8b import REDUCED
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import build
from repro_torch.models import mlp as t_mlp
from repro_torch.models import transformer as t_tf
from repro_torch.models.common import Param, materialize, param_count
from repro_torch.models.model_zoo import extend_cache

B, S, STEPS = 2, 24, 3


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


def bf16_bound(want) -> float:
    return 6 * 2.0**-8 * max(1.0, float(np.max(np.abs(np.asarray(want, np.float32)))))


@pytest.fixture(scope="module")
def setup():
    """fp32-compute configs of both packages, the reference's parameters
    and their port twin, and jitted reference entry points (one per module)."""
    rcfg = dataclasses.replace(REF_REDUCED, compute_dtype="float32")
    tcfg = dataclasses.replace(REDUCED, compute_dtype="float32")
    r_params = r_materialize(r_build(rcfg).params_def, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, r_params)
    t_params = params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, REDUCED.vocab_size, size=(B, S)).astype(np.int32)
    steps = rng.integers(0, REDUCED.vocab_size, size=(STEPS, B, 1)).astype(np.int32)
    jit = {
        "prefill": jax.jit(lambda p, t: r_tf.decoder_prefill(p, t, rcfg)),
        "decode": jax.jit(lambda p, c, t, pos: r_tf.decoder_decode(p, c, t, pos, rcfg)),
        "train": jax.jit(lambda p, t: r_tf.decoder_train(p, t, rcfg)[0]),
    }
    return dict(rcfg=rcfg, tcfg=tcfg, r_params=r_params, tree=tree, t_params=t_params,
                tokens=tokens, steps=steps, jit=jit, rng=rng)


def _layer0(r_params):
    return jax.tree.map(lambda a: a[0], r_params["layers"])


def test_attention_apply_matches(setup):
    rcfg, tcfg = setup["rcfg"], setup["tcfg"]
    x = np.random.default_rng(1).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    y_r, (k_r, v_r) = r_attn.attention_apply(
        _layer0(setup["r_params"])["attn"], jnp.asarray(x), jnp.asarray(pos), rcfg, return_kv=True
    )
    y_t, (k_t, v_t) = t_attn.attention_apply(
        setup["t_params"]["layers"][0]["attn"], torch.tensor(x), torch.tensor(pos), tcfg, return_kv=True
    )
    close(y_t, y_r)
    close(k_t, k_r)
    close(v_t, v_r)
    close(t_attn.attention_apply(setup["t_params"]["layers"][0]["attn"], torch.tensor(x), torch.tensor(pos), tcfg),
          y_r)


def test_attention_decode_matches(setup):
    rcfg, tcfg = setup["rcfg"], setup["tcfg"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S + 4, tcfg.num_kv_heads, tcfg.head_dim)).astype(np.float32) for _ in range(2))
    pos = S
    y_r, kc_r, vc_r = r_attn.attention_decode(
        _layer0(setup["r_params"])["attn"], jnp.asarray(x), jnp.asarray(pos, jnp.int32),
        jnp.asarray(kc), jnp.asarray(vc), rcfg,
    )
    k_t, v_t = torch.tensor(kc), torch.tensor(vc)
    y_t, kc_t, vc_t = t_attn.attention_decode(setup["t_params"]["layers"][0]["attn"], torch.tensor(x), pos, k_t, v_t, tcfg)
    assert kc_t is k_t and vc_t is v_t  # written in place
    close(y_t, y_r)
    close(kc_t, kc_r)
    close(vc_t, vc_r)


def test_mlp_apply_matches(setup):
    rcfg, tcfg = setup["rcfg"], setup["tcfg"]
    x = np.random.default_rng(3).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    close(t_mlp.mlp_apply(setup["t_params"]["layers"][1]["mixer"], torch.tensor(x), tcfg),
          r_mlp.mlp_apply(jax.tree.map(lambda a: a[1], setup["r_params"]["layers"])["mixer"], jnp.asarray(x), rcfg))


def test_decoder_prefill_matches(setup):
    logits_r, cache_r = setup["jit"]["prefill"](setup["r_params"], jnp.asarray(setup["tokens"]))
    logits_t, cache_t = t_tf.decoder_prefill(setup["t_params"], torch.tensor(setup["tokens"]), setup["tcfg"])
    close(logits_t, logits_r)
    assert set(cache_t) == set(cache_r) == {"k", "v"}
    for name in cache_r:
        close(cache_t[name], cache_r[name])


def test_decoder_decode_steps_and_extend_cache_match(setup):
    r_api, t_api = r_build(setup["rcfg"]), build(setup["tcfg"])
    _, cache_r = setup["jit"]["prefill"](setup["r_params"], jnp.asarray(setup["tokens"]))
    _, cache_t = t_tf.decoder_prefill(setup["t_params"], torch.tensor(setup["tokens"]), setup["tcfg"])
    cache_r = r_extend_cache(r_api, cache_r, STEPS + 1)
    cache_t = extend_cache(t_api, cache_t, STEPS + 1)
    for name in cache_r:
        close(cache_t[name], cache_r[name])
        assert cache_t[name].shape[2] == S + STEPS + 1
    assert extend_cache(t_api, cache_t, 0) is cache_t
    for i, tok in enumerate(setup["steps"]):
        logits_r, cache_r = setup["jit"]["decode"](setup["r_params"], cache_r, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits_t, cache_t = t_tf.decoder_decode(setup["t_params"], cache_t, torch.tensor(tok), S + i, setup["tcfg"])
        close(logits_t, logits_r)
    for name in cache_r:
        close(cache_t[name], cache_r[name])


def test_bf16_compute_logits_within_bound(setup):
    """The working type: bf16 weights and activations in both packages."""
    rcfg = dataclasses.replace(REF_REDUCED, compute_dtype="bfloat16")
    t_params = params_from_numpy(setup["tree"], REDUCED, device="cpu")
    assert t_params["embed"].dtype == torch.bfloat16 and t_params["ln_f"].dtype == torch.float32
    tokens = jnp.asarray(setup["tokens"])
    logits_r, cache_r = jax.jit(lambda p, t: r_tf.decoder_prefill(p, t, rcfg))(setup["r_params"], tokens)
    logits_t, cache_t = t_tf.decoder_prefill(t_params, torch.tensor(setup["tokens"]), REDUCED)
    assert logits_t.dtype == torch.bfloat16
    want = np.asarray(logits_r, np.float32)
    assert np.max(np.abs(logits_t.float().numpy() - want)) <= bf16_bound(want)
    cache_r = r_extend_cache(r_build(rcfg), cache_r, 2)
    cache_t = extend_cache(build(REDUCED), cache_t, 2)
    tok = setup["steps"][0]
    logits_r, _ = r_tf.decoder_decode(setup["r_params"], cache_r, jnp.asarray(tok), jnp.asarray(S, jnp.int32), rcfg)
    logits_t, _ = t_tf.decoder_decode(t_params, cache_t, torch.tensor(tok), S, REDUCED)
    want = np.asarray(logits_r, np.float32)
    assert np.max(np.abs(logits_t.float().numpy() - want)) <= bf16_bound(want)


def test_prefill_decode_consistency(setup):
    """The port's own serving invariant (mirrors tests/test_models.py):
    prefill's last logits equal the full forward's at 2e-3, and one decode
    step equals the full forward over the extended sequence at 5e-3."""
    tcfg, params = setup["tcfg"], setup["t_params"]
    api = build(tcfg)
    tokens = torch.tensor(setup["tokens"])
    logits_pf, cache = api.prefill(params, {"tokens": tokens})
    full, aux = t_tf.decoder_train(params, tokens, tcfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits_pf[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)
    cache = extend_cache(api, cache, 4)
    tok = torch.tensor(setup["steps"][0])
    logits_dec, _ = api.decode(params, cache, tok, S)
    full2, _ = t_tf.decoder_train(params, torch.cat([tokens, tok], dim=1), tcfg)
    np.testing.assert_allclose(logits_dec[:, 0].numpy(), full2[:, -1].numpy(), atol=5e-3, rtol=5e-3)
    # and the port's full forward is the reference's
    close(full, setup["jit"]["train"](setup["r_params"], jnp.asarray(setup["tokens"])))


def test_materialize_init_laws():
    """The reference's laws: fan-in-scaled normals truncated at 2 sigma,
    the embedding N(0, 0.02^2), norm gains ones in fp32; stacked layers
    become one tree per layer."""
    cfg = REDUCED
    api = build(cfg)
    params = materialize(api.params_def, torch.Generator().manual_seed(0), torch.bfloat16)
    assert len(params["layers"]) == cfg.num_layers
    assert sum(p.numel() for p in params.parameters()) == param_count(api.params_def)
    wq = params["layers"][0]["attn"]["wq"].float()
    assert wq.dtype == torch.float32 and params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= 2 * std * (1 + 2**-7)
    assert 0.75 * std < float(wq.std()) < 0.95 * std  # a 2-sigma truncation keeps ~0.88 sigma
    emb = params["embed"].float()
    assert abs(float(emb.std()) - 0.02) < 0.002
    assert params["layers"][1]["ln1"].dtype == torch.float32 and bool((params["ln_f"] == 1).all())
    again = materialize(api.params_def, torch.Generator().manual_seed(0), torch.bfloat16)
    assert torch.equal(again["unembed"], params["unembed"])


def test_params_from_numpy_checks_the_tree(setup):
    bad = dict(setup["tree"])
    bad.pop("unembed")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(bad, setup["tcfg"], device="cpu")
    bad = jax.tree.map(lambda a: a, setup["tree"])
    bad["ln_f"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, setup["tcfg"], device="cpu")
    # an MoE tree (deepseek: stacked MoE mixers, shared experts, dense0)
    from repro.configs.deepseek_moe_16b import REDUCED as REF_DS
    from repro_torch.configs.deepseek_moe_16b import REDUCED as DS

    tree = jax.tree.map(np.asarray, r_materialize(r_build(REF_DS).params_def, jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, DS, device="cpu")
    assert len(params["layers"]) == DS.num_layers - 1 and "mixer" in params["dense0"]
    assert params["layers"][1]["mixer"]["router"].dtype == torch.float32
    assert params["layers"][1]["mixer"]["w_gate"].dtype == torch.bfloat16
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["mixer"]["w_up"] = bad["layers"]["mixer"]["w_up"][:, :-1]
    with pytest.raises(ValueError, match="layers/mixer/w_up: shape"):
        params_from_numpy(bad, DS, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["mixer"]["experts"] = bad["layers"]["mixer"].pop("shared")
    with pytest.raises(ValueError, match="layers/mixer: keys"):
        params_from_numpy(bad, DS, device="cpu")


def test_every_family_builds():
    """Every registered architecture builds at reduced size, the hybrid and
    encoder-decoder ones included, and the int8 KV cache; an unknown family
    raises."""
    int8 = dataclasses.replace(REDUCED, kv_cache_dtype="int8")
    from repro_torch.configs.shapes import ShapeConfig

    assert build(int8).cache_spec(ShapeConfig("s", 8, 1, "prefill"))["k"].dtype == torch.int8
    families = {get_config(n).family for n in ARCH_NAMES}
    assert {"hybrid", "encdec"} <= families
    for name in ARCH_NAMES:
        build(get_config(name, reduced=True))
    with pytest.raises(ValueError, match="unknown family"):
        build(dataclasses.replace(REDUCED, family="rnn"))
    assert isinstance(build(REDUCED).params_def["embed"], Param)
