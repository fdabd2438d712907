"""Port vs reference: each model-zoo family of this slice through its
``ModelApi`` (olmoe, deepseek-moe with its dense layer 0, internvl2 with
patch embeddings, xLSTM, and the int8 KV cache on granite), reduced configs
in fp32; then the cache specs, the cache growth and the serving launcher.

The reference's parameters come over with ``convert.params_from_numpy``;
the same seeded prompts (and patches) go through both packages.  Logits
and caches are pinned at ``max|port - ref| <= 1e-5 * max(1, max|ref|)``
(``tests/test_torch_models.py``'s rule), the MoE aux loss at 1e-6; an int8
cache may differ in a few values by one step (``test_torch_int8_cache.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RefShape
from repro.models import build as r_build
from repro.models import model_zoo as r_zoo
from repro.models import transformer as r_tf
from repro.models import xlstm as r_xl
from repro.models.common import materialize as r_materialize
from repro.serving.kv_cache import init_cache as r_init_cache
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.models import build, extend_cache
from repro_torch.models import model_zoo as t_zoo
from repro_torch.models import transformer as t_tf
from repro_torch.models import xlstm as t_xl
from repro_torch.serving import kv_cache as t_kv
from repro_torch.serving.engine import ServeEngine

B, S, STEPS = 2, 24, 3
#: (name, architecture, config changes): the families of this slice.
CASES = {
    "olmoe": ("olmoe-1b-7b", {}),
    "deepseek": ("deepseek-moe-16b", {}),
    "internvl2": ("internvl2-2b", {}),
    "xlstm": ("xlstm-350m", {"ssm_chunk": 16}),
    "int8": ("granite-3-8b", {"kv_cache_dtype": "int8"}),
}


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


def cache_close(got, want):
    if got.dtype == torch.int8 or got.dtype == torch.bfloat16:
        step = 1.0 if got.dtype == torch.int8 else 2.0**-7 * np.abs(np.asarray(want, np.float32))
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert np.all(diff <= step) and np.count_nonzero(diff) <= 1e-3 * diff.size
    else:
        close(got, want)


def _batch(api_inputs, rng, vocab):
    """Seeded prompt inputs in the specs' order (patches, then tokens)."""
    out = {}
    for k, sp in api_inputs.items():
        if k == "patches":
            out[k] = (rng.standard_normal(sp.shape) * 0.1).astype(np.float32)
        else:
            out[k] = rng.integers(0, vocab, size=sp.shape).astype(np.int32)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    arch, changes = CASES[request.param]
    rcfg = dataclasses.replace(r_get_config(arch, reduced=True), compute_dtype="float32", **changes)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32", **changes)
    r_api, t_api = r_build(rcfg), build(tcfg)
    r_params = r_materialize(r_api.params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    shape = ShapeConfig("s", S + tcfg.frontend_tokens, B, "prefill")
    batch = _batch(t_api.prefill_inputs(shape), rng, tcfg.vocab_size)
    steps = rng.integers(0, tcfg.vocab_size, size=(STEPS, B, 1)).astype(np.int32)
    return dict(name=request.param, rcfg=rcfg, tcfg=tcfg, r_api=r_api, t_api=t_api, r_params=r_params,
                t_params=t_params, batch=batch, steps=steps, shape=shape)


def _r_batch(f):
    return {k: jnp.asarray(v) for k, v in f["batch"].items()}


def _t_batch(f):
    return {k: torch.tensor(v) for k, v in f["batch"].items()}


def test_prefill_extend_and_decode_match(family):
    f = family
    r_api, t_api = f["r_api"], f["t_api"]
    lg_r, c_r = jax.jit(r_api.prefill)(f["r_params"], _r_batch(f))
    lg_t, c_t = t_api.prefill(f["t_params"], _t_batch(f))
    close(lg_t, lg_r)
    assert set(c_t) == set(c_r)
    for name in c_r:
        cache_close(c_t[name], c_r[name])
    c_r, c_t = r_zoo.extend_cache(r_api, c_r, STEPS + 1), extend_cache(t_api, c_t, STEPS + 1)
    for name in c_r:
        assert tuple(c_t[name].shape) == tuple(c_r[name].shape), name
    pos0 = f["shape"].seq_len  # patches + tokens
    decode = jax.jit(r_api.decode)
    for i, tok in enumerate(f["steps"]):
        lg_r, c_r = decode(f["r_params"], c_r, jnp.asarray(tok), jnp.asarray(pos0 + i, jnp.int32))
        lg_t, c_t = t_api.decode(f["t_params"], c_t, torch.tensor(tok), pos0 + i)
        close(lg_t, lg_r)
    for name in c_r:
        cache_close(c_t[name], c_r[name])


def _full(f, tokens, prefix, which):
    if f["tcfg"].family == "ssm":
        if which == "ref":
            return r_xl.xlstm_train(f["r_params"], jnp.asarray(tokens), f["rcfg"])
        return t_xl.xlstm_train(f["t_params"], torch.tensor(tokens), f["tcfg"])
    if which == "ref":
        return r_tf.decoder_train(f["r_params"], jnp.asarray(tokens), f["rcfg"],
                                  prefix_embeds=None if prefix is None else jnp.asarray(prefix))
    return t_tf.decoder_train(f["t_params"], torch.tensor(tokens), f["tcfg"],
                              prefix_embeds=None if prefix is None else torch.tensor(prefix))


def test_full_forward_and_aux_match(family):
    """The full forward (the consistency checks' oracle) and the MoE aux
    loss, port against reference."""
    f = family
    prefix = f["batch"].get("patches")
    logits_r, aux_r = _full(f, f["batch"]["tokens"], prefix, "ref")
    logits_t, aux_t = _full(f, f["batch"]["tokens"], prefix, "port")
    close(logits_t, logits_r)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6
    if f["tcfg"].family == "moe":
        assert float(aux_t) > 0


def test_prefill_decode_consistency(family):
    """The reference's serving invariant on the port (``tests/test_models.py``):
    prefill's last logits equal the full forward's at 2e-3, one decode step
    the full forward over the extended prompt at 5e-3.  MoE takes capacity
    factor 8, as there, so that no token is dropped in either.  An int8
    cache is lossy by design: its decode step is held to the full forward
    by the reference's int8 pins instead (cosine > 0.999, argmax equal)."""
    f = family
    tcfg = dataclasses.replace(f["tcfg"], capacity_factor=8.0)
    api = build(tcfg)
    g = dict(f, tcfg=tcfg)
    prefix = f["batch"].get("patches")
    logits_pf, cache = api.prefill(f["t_params"], _t_batch(f))
    full, _ = _full(g, f["batch"]["tokens"], prefix, "port")
    np.testing.assert_allclose(logits_pf[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)
    cache = extend_cache(api, cache, 4)
    tok = f["steps"][0]
    logits_dec, _ = api.decode(f["t_params"], cache, torch.tensor(tok), f["shape"].seq_len)
    full2, _ = _full(g, np.concatenate([f["batch"]["tokens"], tok], axis=1), prefix, "port")
    got, want = logits_dec[:, 0], full2[:, -1]
    if tcfg.kv_cache_dtype == "int8":
        assert float((got * want).sum() / (got.norm() * want.norm())) > 0.999
        assert torch.equal(got.argmax(-1), want.argmax(-1))
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3, rtol=5e-3)


def test_cache_spec_matches_prefill_and_reference(family):
    """``cache_spec`` names exactly the prefill cache's entries, shapes and
    dtypes, and the reference's spec the same shapes; ``init_cache``
    allocates it (the sLSTM stabilizer at -1e30, as the reference's)."""
    f = family
    _, cache = f["t_api"].prefill(f["t_params"], _t_batch(f))
    spec = f["t_api"].cache_spec(f["shape"])
    assert set(cache) == set(spec)
    for name, sp in spec.items():
        assert (tuple(cache[name].shape), cache[name].dtype) == (sp.shape, sp.dtype), name
    rshape = RefShape("s", f["shape"].seq_len, B, "prefill")
    r_spec = f["r_api"].cache_spec(rshape)
    assert {n: sp.shape for n, sp in spec.items()} == {n: tuple(sp.shape) for n, sp in r_spec.items()}
    fresh, r_fresh = t_kv.init_cache(f["t_api"], f["shape"], device="cpu"), r_init_cache(f["r_api"], rshape)
    for name in spec:
        np.testing.assert_array_equal(fresh[name].float().numpy(), np.asarray(r_fresh[name], np.float32))
    assert t_kv.cache_bytes(f["t_api"], f["shape"]) == sum(
        int(np.prod(sp.shape)) * np.dtype(sp.dtype).itemsize for sp in r_spec.values())


def test_extend_cache_grows_the_reference_axes(family):
    f = family
    _, c_t = f["t_api"].prefill(f["t_params"], _t_batch(f))
    grown = extend_cache(f["t_api"], c_t, 5)
    assert t_zoo._GROWABLE[f["tcfg"].family] == r_zoo._GROWABLE[f["tcfg"].family]
    for name, x in c_t.items():
        axis = t_zoo._GROWABLE[f["tcfg"].family].get(name)
        want = list(x.shape)
        if axis is not None:
            want[axis] += 5
            assert float(grown[name].narrow(axis, x.shape[axis], 5).float().abs().sum()) == 0.0
        assert list(grown[name].shape) == want, name
    assert extend_cache(f["t_api"], c_t, 0) is c_t


def test_engine_generate_decodes_after_the_whole_prompt(family):
    """ServeEngine.generate's greedy tokens equal the reference model's
    greedy decode from the prompt's full length (patches included)."""
    f = family
    engine = ServeEngine(f["t_api"], f["shape"], f["t_params"])
    got = engine.generate(_t_batch(f), STEPS + 1).numpy()
    lg, cache = jax.jit(f["r_api"].prefill)(f["r_params"], _r_batch(f))
    cache = r_zoo.extend_cache(f["r_api"], cache, STEPS + 1)
    toks = [np.asarray(lg[:, -1].argmax(-1), np.int32)]
    decode = jax.jit(f["r_api"].decode)
    for i in range(STEPS):
        lg, cache = decode(f["r_params"], cache, jnp.asarray(toks[-1][:, None]),
                           jnp.asarray(f["shape"].seq_len + i, jnp.int32))
        toks.append(np.asarray(lg[:, -1].argmax(-1), np.int32))
    np.testing.assert_array_equal(got, np.stack(toks, axis=1))


def test_decode_step_reads_nothing_on_the_host(family, monkeypatch):
    """A decode step of every family reads no tensor back to the host (on
    the card, ``chip_smoke.py`` runs one under ``set_sync_debug_mode``)."""
    f = family
    _, cache = f["t_api"].prefill(f["t_params"], _t_batch(f))
    cache = extend_cache(f["t_api"], cache, 2)
    armed = {"on": False}

    def guard(name, orig):
        def guarded(self, *args, **kwargs):
            if armed["on"]:
                raise AssertionError(f"the decode step read a tensor on the host ({name})")
            return orig(self, *args, **kwargs)
        return guarded

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    armed["on"] = True
    try:
        logits, _ = f["t_api"].decode(f["t_params"], cache, torch.tensor(f["steps"][0]), f["shape"].seq_len)
    finally:
        armed["on"] = False
    assert logits.shape[:2] == (B, 1)


def test_builds_and_queued_families():
    """Every registered architecture builds but the hybrid and
    encoder-decoder ones, whose messages cite their ROADMAP items."""
    queued = {n for n in ARCH_NAMES if get_config(n).family in ("hybrid", "encdec")}
    assert queued == {"zamba2-7b", "seamless-m4t-large-v2"}
    for name in ARCH_NAMES:
        cfg = get_config(name)
        if name in queued:
            with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 9\.[46]"):
                build(cfg)
            continue
        api = build(cfg)
        assert t_zoo.model_flops(cfg, ShapeConfig("d", 64, 2, "decode")) == r_zoo.model_flops(
            r_get_config(name), RefShape("d", 64, 2, "decode"))
        assert t_kv.params_bytes(api) > 0
    int8 = build(dataclasses.replace(get_config("internlm2-1.8b"), kv_cache_dtype="int8"))
    assert int8.cache_spec(ShapeConfig("s", 8, 1, "prefill"))["k"].dtype == torch.int8


def test_serve_main_serves_the_default_archs(capsys):
    """The launcher's defaults (internlm2-1.8b, xlstm-350m, olmoe-1b-7b)
    all serve; none is skipped."""
    t_serve.main(["--device", "cpu", "--requests", "6"])
    out = capsys.readouterr().out
    assert "skipped" not in out
    for name in ("internlm2-1.8b", "xlstm-350m", "olmoe-1b-7b"):
        assert f"{name}/generate registered" in out
        line = next(ln for ln in out.splitlines() if f"{name}/generate " in ln and "J/inv=" in ln)
        assert "usd/inv=" in line
    assert "== serving 6 requests ==" in out


def test_random_batch_draws_patches_as_the_reference():
    """A VLM batch: float patches N(0, 0.1^2) then tokens, in the specs'
    order from one generator, as the reference's launcher draws them."""
    api = build(get_config("internvl2-2b", reduced=True))
    shape = ShapeConfig("s", 24, 2, "prefill")
    batch = t_serve.random_batch(api, shape, np.random.default_rng(4), "cpu")
    assert list(batch) == ["patches", "tokens"]
    assert batch["patches"].dtype == torch.bfloat16 and batch["patches"].shape == (2, 8, 32)
    rng = np.random.default_rng(4)
    want_p = torch.as_tensor(rng.standard_normal((2, 8, 32)) * 0.1, dtype=torch.bfloat16)
    want_t = rng.integers(0, api.cfg.vocab_size, size=(2, 16))
    assert torch.equal(batch["patches"], want_p)
    np.testing.assert_array_equal(batch["tokens"].numpy(), want_t)
