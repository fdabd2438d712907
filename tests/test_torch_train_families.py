"""Port vs reference: every model family's training loss and gradients,
through ``ModelApi.loss``, on the CPU.

Each family's reduced config runs in fp32 compute on the reference's
initial parameters (``convert.train_state_from_numpy``) and the reference's
synthetic batch (``data.pipeline.synthetic_batch``, bit for bit the same):
the port's loss through a ``ComputeView`` of its fp32 masters and
``torch.autograd.grad`` against ``jax.value_and_grad`` of the reference's
``api.loss``.  The loss is pinned at 1e-5 and every gradient leaf at 1e-4
of scale (``max(1, max|reference|)`` over all leaves), the per-layer
gradients stacked back into the reference's (L, ...) leaves.  The metrics
(nll, tokens, the MoE aux loss) at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RShape
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.models import build as r_build
from repro.models.common import materialize as r_materialize
from repro_torch.configs.registry import get_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.models import build
from repro_torch.models.common import ComputeView, leaf_groups, tree_leaves
from repro_torch.models.model_zoo import MOE_AUX_WEIGHT

#: (architecture, config changes): every family the port serves.
CASES = {
    "internlm2": ("internlm2-1.8b", {}),
    "olmoe": ("olmoe-1b-7b", {}),
    "deepseek": ("deepseek-moe-16b", {}),
    "internvl2": ("internvl2-2b", {}),
    "xlstm": ("xlstm-350m", {"ssm_chunk": 16}),
    "zamba2": ("zamba2-7b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
B, S = 2, 32


@pytest.mark.parametrize("name", list(CASES))
def test_family_loss_and_gradients_match_reference(name):
    arch, changes = CASES[name]
    rcfg = dataclasses.replace(r_get_config(arch, reduced=True), compute_dtype="float32", **changes)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32", **changes)
    r_api, t_api = r_build(rcfg), build(tcfg)
    r_params = r_materialize(r_api.params_def, jax.random.PRNGKey(1))
    batch = r_synthetic_batch(r_api, RShape("t", S, B, "train"), 3)
    (r_loss, r_metrics), r_grads = jax.value_and_grad(r_api.loss, has_aux=True)(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})

    numpy_params = jax.tree.map(np.asarray, r_params)
    params = train_state_from_numpy(numpy_params, numpy_params, numpy_params, 0, cfg=tcfg, device="cpu").params
    t_batch = {k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype.kind == "f" else v) for k, v in batch.items()}
    loss, metrics = t_api.loss(ComputeView(params, torch.float32), t_batch)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True, materialize_grads=True)
    by_id = {id(p): g for p, g in zip(tree_leaves(params), grads)}

    scale = max(1.0, abs(float(r_loss)))
    assert abs(loss.item() - float(r_loss)) <= 1e-5 * scale, (loss.item(), float(r_loss))
    assert set(metrics) == set(r_metrics)
    for k in r_metrics:
        assert abs(metrics[k].item() - float(r_metrics[k])) <= 1e-5 * max(1.0, abs(float(r_metrics[k]))), k
    if tcfg.family == "moe":
        assert metrics["moe_aux"].item() > 0 and MOE_AUX_WEIGHT == 0.01

    flat = {jax.tree_util.keystr(kp): np.asarray(g) for kp, g in jax.tree_util.tree_flatten_with_path(r_grads)[0]}
    g_scale = max(1.0, max(float(np.abs(g).max()) for g in flat.values()))
    groups = leaf_groups(params)
    assert {n for n, _, _ in groups} == set(flat)
    for path, leaves, stacked in groups:
        got = torch.stack([by_id[id(p)] for p in leaves]) if stacked else by_id[id(leaves[0])]
        assert got.shape == flat[path].shape, path
        err = float(np.abs(got.numpy() - flat[path]).max())
        assert err <= 1e-4 * g_scale, (path, err, g_scale)


def test_xlstm_gradients_stay_finite_at_the_example_shape():
    """At ``examples/train_energy.py``'s shape (batch 8 x 128 tokens,
    xlstm-350m reduced) a chunk's cumulative log-decay passes -88, so the
    SSD's masked-out (upper-triangle) decays overflow exp.  The reference
    computes exp(li) then masks it (``repro/models/ssm.py``): the forward is
    right, but the masked infinities turn its gradient into NaN (0 * inf).
    The port masks before the exp: the same loss, finite gradients."""
    r_api, t_api = r_build(r_get_config("xlstm-350m", reduced=True)), build(get_config("xlstm-350m", reduced=True))
    r_params = r_materialize(r_api.params_def, jax.random.PRNGKey(0))
    batch = r_synthetic_batch(r_api, RShape("t", 128, 8, "train"), 0)
    (r_loss, _), r_grads = jax.value_and_grad(r_api.loss, has_aux=True)(r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(r_grads))
    numpy_params = jax.tree.map(np.asarray, r_params)
    params = train_state_from_numpy(numpy_params, numpy_params, numpy_params, 0, cfg=t_api.cfg, device="cpu").params
    loss, _ = t_api.loss(ComputeView(params, torch.bfloat16), {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True, materialize_grads=True)
    assert all(torch.isfinite(g).all() for g in grads)
    assert abs(loss.item() - float(r_loss)) <= 2e-2 * float(r_loss)  # bf16 compute on both sides
