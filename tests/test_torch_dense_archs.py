"""Port vs reference: the three dense architectures that no other file
holds against the JAX package -- granite-3-8b (a vocabulary of 49,155),
nemotron-4-15b (the squared-ReLU MLP, GQA group 3 reduced, 6 at full
width) and qwen2.5-14b (QKV biases, a GQA group of 5) -- reduced, through
their ``ModelApi``.

Both packages get the same numpy weights (``params_from_numpy``), drawn
by each leaf's law with every ``zeros``/``ones`` leaf moved off its
constant (``test_torch_tp._weights``), so that qwen's ``bq``/``bk``/``bv``
are not the zeros ``materialize`` gives them, and the same seeded tokens.
Each case holds the prefill's logits and cache, three decode steps'
logits and the cache after them:

- fp32 compute at ``max|port - ref| <= 1e-5 * max(1, max|ref|)`` (the
  port's cross-framework rule: the same fp32 sums in other orders);
- bf16 compute at ``tests/test_torch_models.py``'s bound, 6 bf16 steps at
  the reference's scale (``6 * 2^-8 * max(1, max|ref|)``): the two
  frameworks round the bf16 activations at other places.

The MLP block (nemotron's squared ReLU, the others' SwiGLU) is held
against ``repro.models.mlp.mlp_apply`` on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.models import build as r_build
from repro.models import mlp as r_mlp
from repro.models import model_zoo as r_zoo
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build, extend_cache
from repro_torch.models import mlp as t_mlp

from test_torch_tp import _weights  # the leaves' laws, constants moved off

ARCHS = ("granite-3-8b", "nemotron-4-15b", "qwen2.5-14b")
B, S, STEPS = 2, 24, 3


def _configs(arch: str, dtype: str):
    return (dataclasses.replace(r_get_config(arch, reduced=True), compute_dtype=dtype),
            dataclasses.replace(get_config(arch, reduced=True), compute_dtype=dtype))


def _bound(want, dtype: str) -> float:
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    return (1e-5 if dtype == "float32" else 6 * 2.0**-8) * scale


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= _bound(want, dtype), (what, err, _bound(want, dtype))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """The architecture, its numpy weights (seeded per architecture) and tokens."""
    name = request.param
    weights = _weights(r_build(_configs(name, "float32")[0]), ARCHS.index(name))
    rng = np.random.default_rng(10 + ARCHS.index(name))
    vocab = get_config(name, reduced=True).vocab_size
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32)
    return name, weights, tokens, steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    name, weights, tokens, steps = arch
    rcfg, tcfg = _configs(name, dtype)
    if tcfg.qkv_bias:  # the bias path is exercised: no bias is its zeros init
        assert all(np.abs(weights["layers"]["attn"][k]).min() > 0 for k in ("bq", "bk", "bv"))
    r_api, t_api = r_build(rcfg), build(tcfg)
    r_params = jax.tree.map(jnp.asarray, weights)
    t_params = params_from_numpy(weights, tcfg, device="cpu")
    decode = jax.jit(r_api.decode)
    lg_r, c_r = jax.jit(r_api.prefill)(r_params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        lg_t, c_t = t_api.prefill(t_params, {"tokens": torch.from_numpy(tokens)})
    _close(lg_t, lg_r, dtype, "prefill logits")
    assert set(c_t) == set(c_r) == {"k", "v"}
    for k in c_r:
        _close(c_t[k], c_r[k], dtype, f"prefill cache {k}")
    c_r, c_t = r_zoo.extend_cache(r_api, c_r, STEPS + 1), extend_cache(t_api, c_t, STEPS + 1)
    for i, tok in enumerate(steps):
        lg_r, c_r = decode(r_params, c_r, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        with torch.no_grad():
            lg_t, c_t = t_api.decode(t_params, c_t, torch.from_numpy(tok), S + i)
        _close(lg_t, lg_r, dtype, f"decode step {i} logits")
    for k in c_r:
        _close(c_t[k], c_r[k], dtype, f"cache {k} after {STEPS} steps")
    assert lg_t.shape[-1] == tcfg.padded_vocab


def test_mlp_apply_matches_reference(arch):
    """Layer 1's MLP block in fp32: squared ReLU for nemotron, SwiGLU else."""
    name, weights, _, _ = arch
    rcfg, tcfg = _configs(name, "float32")
    p = {k: v[1] for k, v in weights["layers"]["mixer"].items()}
    assert ("w_gate" not in p) == (tcfg.mlp == "sq_relu")
    x = np.random.default_rng(3).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    want = r_mlp.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg)
    got = t_mlp.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), tcfg)
    _close(got, want, "float32", "mlp_apply")
