"""Port vs reference: the MoE mixer (``models/moe.py``) on the reduced
olmoe and deepseek-moe configs in fp32.

The reference's parameters (``materialize`` with ``PRNGKey(0)``) come over
with ``convert.params_from_numpy``; the same seeded numpy activations go
through both packages.  Routing is pinned exactly (top-k indices, expert
positions, the dropped (token, slot) pairs), outputs at ``max|port - ref|
<= 1e-5 * max(1, max|ref|)`` (the port's cross-framework rule) and the
Switch aux loss at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.models import build as r_build
from repro.models import moe as r_moe
from repro.models.common import materialize as r_materialize
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as t_moe

T = 64  # tokens routed per call (B 2 x S 32)


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "deepseek-moe-16b"])
def pair(request):
    """fp32 configs of both packages, layer 0's mixer parameters of each,
    and seeded activations."""
    rcfg = dataclasses.replace(r_get_config(request.param, reduced=True), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(request.param, reduced=True), compute_dtype="float32")
    r_params = r_materialize(r_build(rcfg).params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    x = np.random.default_rng(7).standard_normal((T, tcfg.d_model)).astype(np.float32)
    r_mixer = jax.tree.map(lambda a: a[0], r_params["layers"])["mixer"]
    return rcfg, tcfg, r_mixer, t_params["layers"][0]["mixer"], x


def _with(cfgs, **kw):
    return tuple(dataclasses.replace(c, **kw) for c in cfgs)


def test_router_matches(pair):
    rcfg, tcfg, r_p, t_p, x = pair
    idx_r, w_r, aux_r = r_moe._router(r_p, jnp.asarray(x), rcfg)
    idx_t, w_t, aux_t = t_moe._router(t_p, torch.tensor(x), tcfg)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    assert w_t.dtype == torch.float32 and t_p["router"].dtype == torch.float32
    close(w_t, w_r)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6


@pytest.mark.parametrize("n,e", [(128, 8), (37, 5), (1, 4), (512, 64)])
def test_expert_positions_exact(n, e):
    flat = np.random.default_rng(n).integers(0, e, size=n)
    want = np.asarray(r_moe._expert_positions(jnp.asarray(flat, jnp.int32), e))
    got = t_moe._expert_positions(torch.tensor(flat), e)
    np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_dispatch_drops_the_same_entries(pair):
    """At capacity factor 1.0 (16 slots an expert for 128 entries over 8
    experts) some entries are dropped; the port drops the same ones."""
    rcfg, tcfg = _with(pair[:2], capacity_factor=1.0)
    r_p, t_p, x = pair[2:]
    cap = t_moe._capacity(tcfg, T)
    assert cap == 16
    idx_r, _, _ = r_moe._router(r_p, jnp.asarray(x), rcfg)
    keep_r = np.asarray(r_moe._expert_positions(idx_r.reshape(-1), rcfg.num_experts)) < cap
    idx_t, _, _ = t_moe._router(t_p, torch.tensor(x), tcfg)
    keep_t = (t_moe._expert_positions(idx_t.reshape(-1), tcfg.num_experts) < cap).numpy()
    assert (~keep_r).sum() > 0, "the test needs dropped entries"
    np.testing.assert_array_equal(keep_t, keep_r)
    out_r, aux_r = r_moe._moe_capacity(r_p, jnp.asarray(x), rcfg)
    out_t, aux_t = t_moe._moe_capacity(t_p, torch.tensor(x), tcfg)
    close(out_t, out_r)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6


def test_ragged_dispatch_matches(pair):
    rcfg, tcfg = _with(pair[:2], router_impl="ragged")
    r_p, t_p, x = pair[2:]
    out_r, aux_r = r_moe._moe_ragged(r_p, jnp.asarray(x), rcfg)
    out_t, aux_t = t_moe._moe_ragged(t_p, torch.tensor(x), tcfg)
    close(out_t, out_r)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6
    # dropless: capacity dispatch with room for every entry gives the same
    roomy = dataclasses.replace(tcfg, router_impl="capacity", capacity_factor=float(tcfg.num_experts))
    close(t_moe._moe_capacity(t_p, torch.tensor(x), roomy)[0], out_r)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_apply_matches(pair, impl):
    """(B, S, d) through the whole mixer, with deepseek's shared experts
    (width num_shared_experts * expert_d_ff) added densely."""
    rcfg, tcfg = _with(pair[:2], router_impl=impl)
    r_p, t_p, x = pair[2:]
    if tcfg.num_shared_experts:
        assert t_p["shared"]["w_up"].shape == (tcfg.d_model, tcfg.num_shared_experts * tcfg.expert_d_ff)
    else:
        assert "shared" not in t_p
    x3 = x.reshape(2, T // 2, -1)
    out_r, aux_r = r_moe.moe_apply(r_p, jnp.asarray(x3), rcfg)
    out_t, aux_t = t_moe.moe_apply(t_p, torch.tensor(x3), tcfg)
    close(out_t, out_r)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-6
