"""Port vs reference: the encoder-decoder family (seamless-m4t-large-v2),
cross-attention, and the serving launcher on the hybrid and
encoder-decoder families.

The reduced seamless config (2 encoder + 2 decoder layers) in fp32; the
reference's parameters come over with ``convert.params_from_numpy`` and the
same seeded numpy inputs go through both packages.  Values are pinned at
``max|port - ref| <= 1e-5 * max(1, max|ref|)``; the serving invariant at
the reference's own 2e-3 / 5e-3 (``tests/test_models.py``).  The source
has ``S_SRC`` frames, more than the target's ``S`` tokens, so that every
cross-attention here has S != T.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RefShape
from repro.models import attention as r_attn
from repro.models import build as r_build
from repro.models import encdec as r_ed
from repro.models import model_zoo as r_zoo
from repro.models.common import materialize as r_materialize
from repro.serving.kv_cache import init_cache as r_init_cache
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import build, extend_cache
from repro_torch.models import encdec as t_ed
from repro_torch.models.common import materialize
from repro_torch.models.model_zoo import prompt_length
from repro_torch.serving import kv_cache as t_kv
from repro_torch.serving.engine import ServeEngine

B, S, S_SRC = 2, 12, 19


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


@pytest.fixture(scope="module")
def seamless():
    rcfg = dataclasses.replace(r_get_config("seamless-m4t-large-v2", reduced=True), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("seamless-m4t-large-v2", reduced=True), compute_dtype="float32")
    r_api, t_api = r_build(rcfg), build(tcfg)
    r_params = r_materialize(r_api.params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    src = (rng.standard_normal((B, S_SRC, tcfg.frontend_dim)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, size=(3, B, 1)).astype(np.int32)
    return dict(rcfg=rcfg, tcfg=tcfg, r_api=r_api, t_api=t_api, r_params=r_params, t_params=t_params,
                src=src, tokens=tokens, steps=steps)


def _r_batch(f, tokens=None):
    return {"src_embeds": jnp.asarray(f["src"]), "tokens": jnp.asarray(f["tokens"] if tokens is None else tokens)}


def _t_batch(f, tokens=None):
    return {"src_embeds": torch.tensor(f["src"]), "tokens": torch.tensor(f["tokens"] if tokens is None else tokens)}


def test_params_carry_across_with_both_stacks(seamless):
    f = seamless
    p = f["t_params"]
    assert len(p["enc_layers"]) == f["tcfg"].encoder_layers and len(p["dec_layers"]) == f["tcfg"].num_layers
    assert "bq" not in p["dec_layers"][0]["cross"] and "ln_x" in p["dec_layers"][1]
    bf16 = materialize(f["t_api"].params_def, torch.Generator().manual_seed(0), torch.bfloat16)
    assert bf16["enc_ln_f"].dtype == torch.float32 and bf16["proj"]["ln"].dtype == torch.float32
    assert bf16["dec_layers"][0]["ln_x"].dtype == torch.float32
    assert bf16["dec_layers"][0]["cross"]["wk"].dtype == torch.bfloat16 and bf16["proj"]["w"].dtype == torch.bfloat16


def test_encode_matches(seamless):
    f = seamless
    want = r_ed.encode(f["r_params"], jnp.asarray(f["src"]), f["rcfg"])
    got = t_ed.encode(f["t_params"], torch.tensor(f["src"]), f["tcfg"])
    close(got, want)


@pytest.mark.parametrize("causal,use_rope", [(False, True), (True, True), (False, False)])
def test_attention_apply_options_match(seamless, causal, use_rope):
    """Self-attention causal or not (the encoder's), with or without rotary
    positions, and its K/V."""
    f = seamless
    x = np.random.default_rng(1).standard_normal((B, S, f["tcfg"].d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    rp = jax.tree.map(lambda a: a[0], f["r_params"]["enc_layers"])["attn"]
    tp = f["t_params"]["enc_layers"][0]["attn"]
    y_r, (k_r, v_r) = r_attn.attention_apply(rp, jnp.asarray(x), jnp.asarray(pos), f["rcfg"], causal=causal,
                                             use_rope=use_rope, return_kv=True)
    y_t, (k_t, v_t) = t_attn.attention_apply(tp, torch.tensor(x), torch.tensor(pos), f["tcfg"], causal=causal,
                                             use_rope=use_rope, return_kv=True)
    close(y_t, y_r)
    close(k_t, k_r)
    close(v_t, v_r)


def test_cross_attention_apply_and_decode_match(seamless):
    """Cross-attention to a memory of S_SRC rows from S queries (full
    sequence), and from one query against the static memory K/V (decode,
    every sequence at length S_SRC); the caches come back untouched."""
    f = seamless
    rng = np.random.default_rng(2)
    d = f["tcfg"].d_model
    x, mem = rng.standard_normal((B, S, d)).astype(np.float32), rng.standard_normal((B, S_SRC, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    rp = jax.tree.map(lambda a: a[1], f["r_params"]["dec_layers"])["cross"]
    tp = f["t_params"]["dec_layers"][1]["cross"]
    y_r = r_attn.attention_apply(rp, jnp.asarray(x), jnp.asarray(pos), f["rcfg"], causal=False,
                                 memory=jnp.asarray(mem), use_rope=False)
    y_t, (k_t, v_t) = t_attn.attention_apply(tp, torch.tensor(x), torch.tensor(pos), f["tcfg"], causal=False,
                                             memory=torch.tensor(mem), use_rope=False, return_kv=True)
    close(y_t, y_r)
    assert k_t.shape == (B, S_SRC, f["tcfg"].num_kv_heads, f["tcfg"].head_dim)
    x1 = x[:, :1]
    cache_shape = (B, S + 4, f["tcfg"].num_kv_heads, f["tcfg"].head_dim)
    kc, vc = torch.zeros(cache_shape), torch.zeros(cache_shape)
    k_mem, v_mem = r_ed._cross_kv({"cross": rp}, jnp.asarray(mem), f["rcfg"])
    close(k_t, k_mem)
    close(v_t, v_mem)
    y_r, _, _ = r_attn.attention_decode(rp, jnp.asarray(x1), jnp.asarray(3, jnp.int32), jnp.asarray(kc.numpy()),
                                        jnp.asarray(vc.numpy()), f["rcfg"], memory_kv=(k_mem, v_mem))
    y_t, kc2, vc2 = t_attn.attention_decode(tp, torch.tensor(x1), 3, kc, vc, f["tcfg"], memory_kv=(k_t, v_t))
    close(y_t, y_r)
    assert kc2 is kc and vc2 is vc and not kc.any() and not vc.any()


def test_encdec_train_matches(seamless):
    f = seamless
    logits_r, _ = r_ed.encdec_train(f["r_params"], jnp.asarray(f["src"]), jnp.asarray(f["tokens"]), f["rcfg"])
    logits_t, aux = t_ed.encdec_train(f["t_params"], torch.tensor(f["src"]), torch.tensor(f["tokens"]), f["tcfg"])
    close(logits_t, logits_r)
    assert float(aux) == 0.0


def test_encdec_prefill_and_decode_match(seamless):
    f = seamless
    lg_r, c_r = jax.jit(f["r_api"].prefill)(f["r_params"], _r_batch(f))
    lg_t, c_t = f["t_api"].prefill(f["t_params"], _t_batch(f))
    close(lg_t, lg_r)
    assert set(c_t) == set(c_r) == {"k", "v", "cross_k", "cross_v"}
    for name in c_r:
        close(c_t[name], c_r[name])
    assert c_t["cross_k"].shape[2] == S_SRC and c_t["k"].shape[2] == S
    c_r, c_t = r_zoo.extend_cache(f["r_api"], c_r, 4), extend_cache(f["t_api"], c_t, 4)
    assert c_t["cross_k"].shape[2] == S_SRC and c_t["k"].shape[2] == S + 4
    cross = c_t["cross_k"].clone()
    decode = jax.jit(f["r_api"].decode)
    for i, tok in enumerate(f["steps"]):
        lg_r, c_r = decode(f["r_params"], c_r, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        lg_t, c_t = f["t_api"].decode(f["t_params"], c_t, torch.tensor(tok), S + i)
        close(lg_t, lg_r)
    for name in c_r:
        close(c_t[name], c_r[name])
    assert torch.equal(c_t["cross_k"], cross)  # the memory's K/V never change


def test_encdec_prefill_decode_consistency(seamless):
    """Prefill's last logits equal the full forward's at 2e-3; one decode
    step the full forward over the extended target at 5e-3.  The source
    frames are not decode positions: the step writes at the target's
    length."""
    f = seamless
    assert prompt_length(_t_batch(f)) == S
    logits_pf, cache = f["t_api"].prefill(f["t_params"], _t_batch(f))
    full, _ = t_ed.encdec_train(f["t_params"], torch.tensor(f["src"]), torch.tensor(f["tokens"]), f["tcfg"])
    np.testing.assert_allclose(logits_pf[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)
    cache = extend_cache(f["t_api"], cache, 4)
    tok = f["steps"][0]
    logits_dec, _ = f["t_api"].decode(f["t_params"], cache, torch.tensor(tok), S)
    full2, _ = t_ed.encdec_train(f["t_params"], torch.tensor(f["src"]),
                                 torch.tensor(np.concatenate([f["tokens"], tok], axis=1)), f["tcfg"])
    np.testing.assert_allclose(logits_dec[:, 0].numpy(), full2[:, -1].numpy(), atol=5e-3, rtol=5e-3)


def test_encdec_generate_matches_the_reference_greedy_decode(seamless):
    f = seamless
    shape = ShapeConfig("s", S, B, "prefill")
    got = ServeEngine(f["t_api"], shape, f["t_params"]).generate(_t_batch(f), 4).numpy()
    lg, cache = jax.jit(f["r_api"].prefill)(f["r_params"], _r_batch(f))
    cache = r_zoo.extend_cache(f["r_api"], cache, 4)
    toks = [np.asarray(lg[:, -1].argmax(-1), np.int32)]
    decode = jax.jit(f["r_api"].decode)
    for i in range(3):
        lg, cache = decode(f["r_params"], cache, jnp.asarray(toks[-1][:, None]), jnp.asarray(S + i, jnp.int32))
        toks.append(np.asarray(lg[:, -1].argmax(-1), np.int32))
    np.testing.assert_array_equal(got, np.stack(toks, axis=1))


@pytest.mark.parametrize("s", [12, 5000])  # the cross memory capped at DECODE_SRC_LEN = 4096
def test_encdec_cache_spec_init_and_growth_match_the_reference(seamless, s):
    f = seamless
    shape, rshape = ShapeConfig("s", s, B, "prefill"), RefShape("s", s, B, "prefill")
    spec, r_spec = f["t_api"].cache_spec(shape), f["r_api"].cache_spec(rshape)
    assert {n: sp.shape for n, sp in spec.items()} == {n: tuple(sp.shape) for n, sp in r_spec.items()}
    assert t_kv.cache_bytes(f["t_api"], shape) == sum(
        int(np.prod(sp.shape)) * np.dtype(sp.dtype).itemsize for sp in r_spec.values())
    if s > 4096:
        return
    fresh, r_fresh = t_kv.init_cache(f["t_api"], shape, device="cpu"), r_init_cache(f["r_api"], rshape)
    for name in spec:
        np.testing.assert_array_equal(fresh[name].numpy(), np.asarray(r_fresh[name], np.float32))
    grown = extend_cache(f["t_api"], fresh, 3)
    r_grown = r_zoo.extend_cache(f["r_api"], r_fresh, 3)
    for name in fresh:
        assert tuple(grown[name].shape) == tuple(r_grown[name].shape), name


def test_random_batch_draws_source_frames_as_the_reference():
    """An encoder-decoder batch: float source frames N(0, 0.1^2), then
    tokens, in the specs' order from one generator."""
    api = build(get_config("seamless-m4t-large-v2", reduced=True))
    shape = ShapeConfig("s", 10, 2, "prefill")
    batch = t_serve.random_batch(api, shape, np.random.default_rng(4), "cpu")
    assert list(batch) == ["src_embeds", "tokens"]
    assert batch["src_embeds"].dtype == torch.bfloat16 and batch["src_embeds"].shape == (2, 10, 32)
    rng = np.random.default_rng(4)
    want_s = torch.as_tensor(rng.standard_normal((2, 10, 32)) * 0.1, dtype=torch.bfloat16)
    np.testing.assert_array_equal(batch["tokens"].numpy(), rng.integers(0, api.cfg.vocab_size, size=(2, 10)))
    assert torch.equal(batch["src_embeds"], want_s)


def test_serve_main_serves_the_hybrid_and_encdec_families(capsys):
    """The launcher serves zamba2 and seamless at reduced size on the CPU,
    metered and priced."""
    t_serve.main(["--device", "cpu", "--archs", "zamba2-7b,seamless-m4t-large-v2", "--requests", "4"])
    out = capsys.readouterr().out
    for name in ("zamba2-7b", "seamless-m4t-large-v2"):
        assert f"{name}/generate registered" in out
        line = next(ln for ln in out.splitlines() if f"{name}/generate " in ln and "J/inv=" in ln)
        assert "usd/inv=" in line
    assert "== serving 4 requests ==" in out
