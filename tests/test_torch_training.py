"""Port vs reference: the training slice's kernels layer, optimizer, train
step, data and trainer, on the CPU.

- The flash VJP: ``kernels.ops.flash_attention`` (an autograd Function:
  ``ref.flash_fwd``, then ``ref.flash_bwd``) against ``jax.grad`` of the
  reference's ``ref.flash_attention`` (its ``custom_vjp``), out, lse, dq,
  dk and dv at 1e-5 of scale in fp32; the same Function on its kernel path
  (the ``flash_attention_lse`` and ``flash_attention_bwd`` ops, with the
  plain versions registered as their CPU implementations) at 1e-5, and
  the backward op's fake implementation and FLOP formula.
- The optimizer (schedule, clipping, int8 error feedback, ``update``) on
  the same numpy state and gradients as the reference, at 1e-6.
- One train step against the reference's; ``accum_steps=4`` against 1
  (``tests/test_training.py``'s pins); the remat policies.
- ``synthetic_batch`` bit for bit the reference's; the trainer's
  kill-and-resume bitwise; the straggler watchdog; the launcher.

Scale is ``max(1, max|reference|)``.  Reduced configs run in fp32
(``dataclasses.replace(cfg, compute_dtype="float32")``) where the point is
the algorithm, as ``tests/test_torch_models.py`` does.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RShape
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.kernels import ref as r_ref
from repro.models import build as r_build
from repro.training import optimizer as r_opt
from repro.training.train_step import init_state as r_init_state
from repro.training.train_step import make_train_step as r_make_train_step
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import DataConfig, batch_iterator, synthetic_batch
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as t_train
from repro_torch.models import build
from repro_torch.models.common import ComputeView, leaf_groups, map_tree, tree_leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import init_state, make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig


def close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The flash VJP
# ---------------------------------------------------------------------------

VJP_CASES = [
    # b, s, t, h, hkv, d, causal, q_block, kv_block
    (2, 64, 64, 4, 2, 16, True, 16, 32),     # GQA group 2, several q and kv blocks
    (1, 32, 96, 4, 1, 16, True, 16, 32),     # S < T: causal offset T - S, group 4
    (2, 64, 64, 4, 4, 32, False, 32, 16),    # not causal, group 1, kv blocks smaller than q blocks
    (1, 48, 48, 6, 2, 16, True, 16, 16),     # group 3, square blocks
    (2, 32, 64, 4, 2, 16, False, 16, 16),    # S < T, not causal
]


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,qb,kb", VJP_CASES)
def test_flash_function_matches_reference_vjp(b, s, t, h, hkv, d, causal, qb, kb):
    rng = np.random.default_rng(s * 100 + t + h)
    qn, kn, vn, gn = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d)))
    out_r, (_, _, _, _, lse_r) = r_ref._flash_fwd(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal, qb, kb)
    grads_r = jax.grad(lambda q, k, v: jnp.sum(r_ref.flash_attention(q, k, v, causal, qb, kb) * gn), argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    out = ops.flash_attention(q, k, v, causal=causal, q_block=qb, kv_block=kb)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(gn))
    _, lse = ref.flash_fwd(q.detach(), k.detach(), v.detach(), causal, qb, kb)
    for got, want in zip((out, lse, *grads), (out_r, lse_r, *grads_r)):
        close(got, want, 1e-5)


def test_flash_function_routes_and_keeps_nothing_without_grad(monkeypatch):
    """With a gradient recorded the CPU path is ``flash_fwd`` then
    ``flash_bwd``; without one it is the plain forward alone.  A fake
    tensor takes the ops: its backward reaches ``flash_attention_bwd`` once
    a call and no plain version."""
    seen = []
    for name in ("flash_attention", "flash_fwd", "flash_bwd"):
        real = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=real, **k: seen.append(_n) or _f(*a, **k))
    x = torch.randn(1, 16, 2, 16)
    with torch.no_grad():
        ops.flash_attention(x.requires_grad_(), x, x)
    assert seen == ["flash_attention", "flash_fwd"]  # the plain forward, through its own flash_fwd
    seen.clear()
    out = ops.flash_attention(x, x.detach(), x.detach())
    assert seen == ["flash_fwd"] and out.grad_fn is not None
    out.sum().backward()
    assert seen == ["flash_fwd", "flash_bwd"]
    seen.clear()
    with FakeTensorMode() as mode, _OpLog() as ops_seen:
        q, k = mode.from_tensor(torch.randn(2, 32, 4, 16)), mode.from_tensor(torch.randn(2, 48, 2, 16))
        q.requires_grad_()
        for causal in (True, False):
            torch.autograd.grad(ops.flash_attention(q, k, k, causal=causal).sum(), q)
    assert seen == []
    assert ops_seen.names == ["flash_attention_lse", "flash_attention_bwd"] * 2


class _OpLog(TorchDispatchMode):
    """Records the ``repro_torch`` custom ops called under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", None) == "repro_torch":
            self.names.append(func._opname)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def ops_on_cpu(monkeypatch):
    """The Function's kernel path on the CPU: the plain versions registered
    as the ``flash_attention_lse`` and ``flash_attention_bwd`` ops' CPU
    implementations, and every tensor sent to the ops."""
    lib = torch.library.Library("repro_torch", "IMPL")
    lib.impl("flash_attention_lse", lambda q, k, v, causal: ref.flash_fwd(q, k, v, causal), "CPU")
    lib.impl("flash_attention_bwd",
             lambda q, k, v, out, lse, dout, causal: ref.flash_bwd(q, k, v, out, lse, dout, causal), "CPU")
    monkeypatch.setattr(ops, "_kernel_path", lambda name, x: True)
    yield
    lib._destroy()


@pytest.mark.parametrize("b,s,t,h,hkv,causal,qb,kb", [
    (2, 64, 64, 4, 4, True, 16, 32),    # causal, group 1
    (2, 64, 64, 4, 4, False, 32, 16),   # not causal
    (1, 48, 48, 4, 2, True, 16, 16),    # GQA group 2
    (1, 32, 96, 4, 2, True, 16, 32),    # S < T: the causal offset T - S
])
def test_flash_ops_glue_matches_reference_vjp(b, s, t, h, hkv, causal, qb, kb, ops_on_cpu):
    """The kernel path's glue (the argument order the Function hands the
    ops, the lse layout between them, the causal flag) against ``jax.grad``
    of the reference's ``ref.flash_attention`` at 1e-5 of scale."""
    d = 16
    rng = np.random.default_rng(s + t + h + hkv + causal)
    qn, kn, vn, gn = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d)))
    grads_r = jax.grad(lambda q, k, v: jnp.sum(r_ref.flash_attention(q, k, v, causal, qb, kb) * gn), argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    with _OpLog() as seen:
        out = ops.flash_attention(q, k, v, causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(gn))
    assert seen.names == ["flash_attention_lse", "flash_attention_bwd"]
    for got, want in zip(grads, grads_r):
        close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_fake_and_flops(dtype):
    """The backward op's fake implementation gives the gradients' shapes
    and dtypes, and ``FlopCounterMode`` counts it at 2.5x the forward's
    FLOPs (its five products against the forward's two)."""
    b, s, t, h, hkv, d = 2, 40, 56, 4, 2, 16
    with FakeTensorMode():
        q, k = torch.empty(b, s, h, d, dtype=dtype), torch.empty(b, t, hkv, d, dtype=dtype)
        lse = torch.empty(b, hkv, h // hkv, s)
        for causal in (True, False):
            with FlopCounterMode(display=False) as fwd:
                out, _ = torch.ops.repro_torch.flash_attention_lse(q, k, k, causal)
            with FlopCounterMode(display=False) as bwd:
                grads = torch.ops.repro_torch.flash_attention_bwd(q, k, k, out, lse, out, causal)
            assert [(tuple(g.shape), g.dtype) for g in grads] == [((b, s, h, d), dtype)] + [((b, t, hkv, d), dtype)] * 2
            assert all(g.is_contiguous() for g in grads)
            want = 5 * ops.attention_flops(b, s, t, h, d, causal)
            assert bwd.get_total_flops() * 2 == 5 * fwd.get_total_flops() == want


@pytest.mark.parametrize("b,s,t,causal", [(1, 37, 53, True), (2, 45, 45, False), (1, 20, 70, True)])
def test_flash_function_ragged_against_dense_autograd(b, s, t, causal):
    """Ragged S and T (the reference's blocked VJP needs whole blocks; the
    port pads, as its forward does): against autograd through a dense
    fp32 attention, the reference's own oracle for its VJP, at its pin
    (``tests/test_kernels.py``: atol 3e-4, rtol 1e-3)."""
    rng = np.random.default_rng(s + t)
    h, hkv, d = 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
               for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    got = torch.autograd.grad((ops.flash_attention(q, k, v, causal=causal, q_block=16, kv_block=32) ** 2).sum(),
                              (q, k, v))
    want = jax.grad(lambda q, k, v: jnp.sum(r_ref.attention_dense(q, k, v, causal=causal) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x.detach().numpy()) for x in (q, k, v)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
    for cfg in (opt.OptimizerConfig(learning_rate=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
                opt.OptimizerConfig(total_steps=12, warmup_steps=1)):
        rcfg = r_opt.OptimizerConfig(**dataclasses.asdict(cfg))
        for step in range(0, cfg.total_steps + 3):
            want = float(r_opt.schedule(jnp.asarray(float(step)), rcfg))
            got = float(opt.schedule(torch.tensor(float(step)), cfg))
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (step, got, want)


@pytest.mark.parametrize("magnitude", [100.0, 1e-3])
def test_clipping_matches_reference(magnitude, rng):
    g = {"a": rng.standard_normal((10,)).astype(np.float32) * magnitude,
         "b": [rng.standard_normal((3, 4)).astype(np.float32) * magnitude]}
    want, want_norm = r_opt.clip_by_global_norm({"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]}, 1.0)
    got, got_norm = opt.clip_by_global_norm(map_tree(torch.from_numpy, g), 1.0)
    close(got_norm, want_norm, 1e-6)
    close(got["a"], want["a"], 1e-6)
    close(got["b"][0], want["b"][0], 1e-6)
    if magnitude > 1:
        assert abs(float(torch.linalg.vector_norm(torch.cat([got["a"], got["b"][0].ravel()]))) - 1.0) < 1e-5


def test_quantize_and_error_feedback_match_reference(rng):
    x = rng.standard_normal((128,)).astype(np.float32)
    q, s = opt.quantize_int8(torch.from_numpy(x))
    rq, rs = r_opt.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq)) and abs(float(s) - float(rs)) <= 1e-6 * float(rs)
    assert float((opt.dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()) <= float(s) * 0.51
    g = (rng.standard_normal((64,)) * 0.01).astype(np.float32)
    err, r_err = {"g": torch.zeros(64)}, {"g": jnp.zeros(64)}
    total = torch.zeros(64)
    for _ in range(50):
        out, err = opt.ef_compress({"g": torch.from_numpy(g)}, err)
        r_out, r_err = r_opt.ef_compress({"g": jnp.asarray(g)}, r_err)
        close(out["g"], r_out["g"], 1e-6)
        close(err["g"], r_err["g"], 1e-6)
        total += out["g"]
    rel = float(torch.linalg.vector_norm(total / 50 - torch.from_numpy(g)) / np.linalg.norm(g))
    assert rel < 0.05, rel


@pytest.mark.parametrize("compress", [False, True])
def test_update_matches_reference(compress, rng):
    """Two AdamW steps from the same numpy params, moments and gradients
    (the second from the first's state): parameters, moments, count, error
    buffer and stats at 1e-6 of scale."""
    shapes = {"w": (8, 16), "b": (16,), "layers": {"k": (3, 4, 4)}}
    draw = lambda: jax.tree.map(lambda sh: rng.standard_normal(sh).astype(np.float32), shapes,
                                is_leaf=lambda x: isinstance(x, tuple))
    params = draw()
    cfg = opt.OptimizerConfig(warmup_steps=1, total_steps=10, compress_grads=compress)
    rcfg = r_opt.OptimizerConfig(**dataclasses.asdict(cfg))
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = r_opt.init(r_params, rcfg)
    t_params = {"w": torch.from_numpy(params["w"]), "b": torch.from_numpy(params["b"]),
                "layers": [{"k": torch.from_numpy(params["layers"]["k"][i].copy())} for i in range(3)]}
    t_state = opt.init(t_params, cfg)
    for _ in range(2):
        grads = draw()
        r_params, r_state, r_stats = r_opt.update(jax.tree.map(jnp.asarray, grads), r_state, r_params, rcfg)
        t_grads = {"w": torch.from_numpy(grads["w"]), "b": torch.from_numpy(grads["b"]),
                   "layers": [{"k": torch.from_numpy(grads["layers"]["k"][i].copy())} for i in range(3)]}
        t_params, t_state, t_stats = opt.update(t_grads, t_state, t_params, cfg)
        for name in ("grad_norm", "lr"):
            close(t_stats[name], r_stats[name], 1e-6)
        assert int(t_state.count) == int(r_state.count)
        trees = [(t_params, r_params), (t_state.mu, r_state.mu), (t_state.nu, r_state.nu)]
        if compress:
            trees.append((t_state.err, r_state.err))
        for t_tree, r_tree in trees:
            close(t_tree["w"], r_tree["w"], 1e-6)
            close(t_tree["b"], r_tree["b"], 1e-6)
            close(torch.stack([layer["k"] for layer in t_tree["layers"]]), r_tree["layers"]["k"], 1e-6)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

SHAPE = (4, 32)  # batch, seq


def _configs(arch="internlm2-1.8b", **changes):
    rcfg = dataclasses.replace(r_get_config(arch, reduced=True), compute_dtype="float32", **changes)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32", **changes)
    return rcfg, tcfg


def test_train_step_matches_reference():
    """One ``make_train_step`` from the reference's initial state on the
    reference's batch: loss and gradient norm at 1e-5 of scale; the new
    parameters at 1e-6 wherever the reference's gradient is above 1e-4 of
    its scale.  AdamW's first step is about lr * sign(g), so where a
    gradient is as small as the two frameworks' difference (~1e-6) its
    sign, and the step, may differ; ``test_update_matches_reference`` pins
    the update itself on identical gradients."""
    rcfg, tcfg = _configs()
    r_api, t_api = r_build(rcfg), build(tcfg)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=50)
    rocfg = r_opt.OptimizerConfig(**dataclasses.asdict(ocfg))
    r_state = r_init_state(r_api, jax.random.PRNGKey(0), rocfg)
    p0 = _np_tree(r_state.params)
    zeros = jax.tree.map(np.zeros_like, p0)
    t_state = train_state_from_numpy(p0, zeros, zeros, 0, cfg=tcfg, device="cpu")
    batch = r_synthetic_batch(r_api, RShape("t", SHAPE[1], SHAPE[0], "train"), 0)
    grads = jax.grad(lambda p: r_api.loss(p, batch)[0])(r_state.params)
    r_new, r_metrics = jax.jit(r_make_train_step(r_api, rocfg))(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    t_new, t_metrics = make_train_step(t_api, ocfg)(t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("loss", "grad_norm", "nll", "lr"):
        close(t_metrics[name], r_metrics[name], 1e-5)
    assert int(t_new.opt.count) == 1
    flat = {jax.tree_util.keystr(kp): (np.asarray(p), np.asarray(g)) for (kp, p), (_, g) in zip(
        jax.tree_util.tree_flatten_with_path(r_new.params)[0], jax.tree_util.tree_flatten_with_path(grads)[0])}
    g_scale = max(float(np.abs(g).max()) for _, g in flat.values())
    checked = 0
    for name, leaves, stacked in leaf_groups(t_new.params):
        got = (torch.stack(leaves) if stacked else leaves[0]).detach().numpy()
        want, g = flat[name]
        sure = np.abs(g) > 1e-4 * g_scale
        assert np.max(np.abs(got - want)[sure], initial=0.0) <= 1e-6 * max(1.0, float(np.abs(want).max())), name
        checked += int(sure.sum())
    assert checked > 0.5 * sum(p.size for p, _ in flat.values())


def test_accumulation_equivalence():
    """accum=4 microbatching gives (nearly) the same update as accum=1, at
    the reference's own pins (``tests/test_training.py``), bf16 compute."""
    api = build(get_config("internlm2-1.8b", reduced=True))
    ocfg = opt.OptimizerConfig(total_steps=50, warmup_steps=2)
    batch = synthetic_batch(api, ShapeConfig("t", SHAPE[1], SHAPE[0], "train"), 0)
    states = [init_state(api, torch.Generator().manual_seed(0), ocfg) for _ in range(2)]
    s1, m1 = make_train_step(api, ocfg)(states[0], batch)
    s4, m4 = make_train_step(api, ocfg, accum_steps=4)(states[1], batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-3, rtol=5e-3)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b", "seamless-m4t-large-v2"])
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    """"full" and "dots" recompute in the backward and give "none"'s
    gradients bit for bit; under "full" each attention layer's forward runs
    twice (the recompute), as the card's launch count has it."""
    _, base = _configs(arch)
    calls = []
    real = ref.flash_fwd
    monkeypatch.setattr(ref, "flash_fwd", lambda *a, **k: calls.append(1) or real(*a, **k))
    results = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=policy)
        api = build(cfg)
        params = init_state(api, torch.Generator().manual_seed(0), opt.OptimizerConfig()).params
        batch = synthetic_batch(api, ShapeConfig("t", 16, 2, "train"), 0)
        calls.clear()
        loss, _ = api.loss(ComputeView(params, torch.float32), batch)
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True, materialize_grads=True)
        results[policy] = (loss.item(), grads, len(calls))
    for policy in ("full", "dots"):
        assert results[policy][0] == results["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(results[policy][1], results["none"][1])), policy
    assert results["full"][2] == 2 * results["none"][2] > 0


def test_unknown_remat_policy_raises():
    from repro_torch.models.common import maybe_remat

    with pytest.raises(ValueError, match="remat"):
        maybe_remat(lambda x: x, "some")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "internvl2-2b", "seamless-m4t-large-v2"])
def test_synthetic_batch_is_the_reference_bit_for_bit(arch):
    """Tokens, labels and the bf16 patch / frame embeddings of the reduced
    configs, batch by batch; and ``batch_iterator`` seeks to a step."""
    r_api, t_api = r_build(r_get_config(arch, reduced=True)), build(get_config(arch, reduced=True))
    for step in (0, 7):
        want = r_synthetic_batch(r_api, RShape("t", 24, 3, "train"), step, RDataConfig(seed=5))
        got = synthetic_batch(t_api, ShapeConfig("t", 24, 3, "train"), step, DataConfig(seed=5))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == t_api.train_inputs(ShapeConfig("t", 24, 3, "train"))[k].dtype
            assert np.array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32)), (arch, step, k)
    it = batch_iterator(t_api, ShapeConfig("t", 24, 3, "train"), DataConfig(seed=5), start_step=7)
    assert all(torch.equal(a, b) for a, b in zip(next(it).values(), got.values()))


# ---------------------------------------------------------------------------
# Trainer and launcher
# ---------------------------------------------------------------------------


def test_trainer_kill_and_resume_is_bitwise(tmp_path):
    """10 straight steps == 5 steps + crash + a fresh trainer resuming 5,
    bit for bit on the CPU: every loss and every final parameter (olmoe:
    the routed dispatch's scatters and gathers in the step too)."""
    api = build(get_config("olmoe-1b-7b", reduced=True))
    ocfg = opt.OptimizerConfig(total_steps=50, warmup_steps=2)
    step = make_train_step(api, ocfg)
    shape = ShapeConfig("t", SHAPE[1], SHAPE[0], "train")

    def factory(start):
        return batch_iterator(api, shape, DataConfig(seed=2), start_step=start)

    def fresh():
        return init_state(api, torch.Generator().manual_seed(0), ocfg)

    t_a = Trainer(step, fresh(), factory, TrainerConfig(total_steps=10, checkpoint_every=100,
                                                         checkpoint_dir=str(tmp_path / "a")))
    rep_a = t_a.run()
    Trainer(step, fresh(), factory, TrainerConfig(total_steps=5, checkpoint_every=100,
                                                  checkpoint_dir=str(tmp_path / "b"))).run()
    t_b = Trainer(step, fresh(), factory, TrainerConfig(total_steps=10, checkpoint_every=100,
                                                        checkpoint_dir=str(tmp_path / "b")))
    rep_b = t_b.run()
    assert rep_b.resumed_from == 5 and rep_b.steps_run == 5
    assert rep_b.losses == rep_a.losses[5:]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t_a.state), tree_leaves(t_b.state)))
    assert int(t_b.state.opt.count) == 10


def test_straggler_watchdog():
    """A step 10x slower than the median is counted as a straggler."""
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        time.sleep(0.3 if calls["n"] == 12 else 0.005)
        return state, {"loss": torch.tensor(1.0)}

    rep = Trainer(slow_step, None, lambda s: iter(lambda: {}, None),
                  TrainerConfig(total_steps=15, watchdog_factor=3.0, watchdog_warmup=3)).run()
    assert rep.straggler_steps >= 1 and rep.steps_run == 15


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU at the reduced config: the loss
    falls, checkpoints land at the cadence and at the end, and a relaunch
    after losing the last one resumes from the one before, bit for bit."""
    argv = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "12", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--device", "cpu"]
    rep1, state1 = t_train.main(argv)
    assert rep1.steps_run == 12 and rep1.losses[-1] < rep1.losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004", "step_00000008", "step_00000012"]
    import shutil

    shutil.rmtree(tmp_path / "step_00000012")
    rep2, state2 = t_train.main(argv)
    assert rep2.resumed_from == 8 and rep2.losses == rep1.losses[8:]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state1), tree_leaves(state2)))
    out = capsys.readouterr().out
    assert "done: 12 steps" in out and "resumed_from=8" in out
    with pytest.raises(RuntimeError, match="needs 256 ranks"):  # one process: no pod mesh
        t_train.main([*argv, "--mesh", "pod"])


def test_cast_params_step():
    """``cast_params`` (the reference's cast of the fp32 masters of two or
    more dims once, before the forward): in fp32 compute the casts are the
    identity and the step is the same bits as without; in bf16 it trains
    the same step to bf16's precision (the per-use and the once-only casts
    round the same weights, and differ only where a weight's gradient is
    summed: in fp32 per use, in bf16 once)."""
    ocfg = opt.OptimizerConfig(total_steps=50, warmup_steps=2)
    for cfg, tol in ((_configs()[1], 0.0), (get_config("internlm2-1.8b", reduced=True), 2e-2)):
        api = build(cfg)
        batch = synthetic_batch(api, ShapeConfig("t", SHAPE[1], SHAPE[0], "train"), 0)
        (s1, m1), (s2, m2) = ((make_train_step(api, ocfg, cast_params=c)(
            init_state(api, torch.Generator().manual_seed(0), ocfg), batch)) for c in (False, True))
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= tol * float(m1["loss"])
        if tol == 0.0:
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s1), tree_leaves(s2)))
