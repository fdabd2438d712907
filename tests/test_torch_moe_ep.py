"""The MoE block's expert-parallel path (``repro_torch.models.moe``) on one
group of 4 gloo ranks, mesh (data = 2, model = 2), against the reference.

The oracle is the reference's own (``tests/test_collectives_and_moe.py::
test_moe_ep_matches_single_shard``): EP routes each token shard on its own,
so it must equal ``_moe_capacity`` run once per token half, with the
capacity of a half.  Reduced olmoe-1b-7b and deepseek-moe-16b (shared
experts), fp32:

- the exact all-to-all: the output per rank at 1e-5 of scale, the aux loss
  against the mean of the halves', the gradients of x per half and of the
  router, the three expert weights and the shared experts summed over the
  ranks, against ``jax.grad`` of the capacity path per half, at 1e-4 of
  scale;
- the int8 all-to-all: the output against the same dispatch with each
  buffer row quantized and dequantized as the reference's ``_q_a2a`` does
  (the all-to-all only moves rows), at 1e-5 of scale, and within two
  row-quantization steps of the exact path;
- ``DTensor`` inputs (olmoe): tokens placed by the batch rule and weights
  by ``TRAIN_RULES`` give the same output and gradients;
- deepseek's whole decoder (its dense layer 0, then MoE layers on the EP
  path) through ``api.loss`` per rank: the nll of each half and the MoE
  aux (the mean over the halves) against the reference's ``api.loss``.

One rank group for the module (``FileStore`` rendezvous, ``python -c``
subprocesses under their own timeout).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RShape
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.models import build as r_build
from repro.models import moe as r_moe
from repro.models.common import materialize as r_materialize
from repro.models.mlp import mlp_apply as r_mlp_apply

from test_torch_collectives import run_ranks  # one launcher for every rank group

ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
B, S = 4, 8
EXPERT = ("w_gate", "w_up", "w_down")


RANK_CODE = """
    import dataclasses, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build, moe
    from repro_torch.models.common import ComputeView

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    half = mesh.get_coordinate()[0]
    with open(f"{tmp}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {}

    def leaves(p):
        return {k: v for k, v in p.items() if k != "shared"} | {f"shared.{k}": v for k, v in p.get("shared", {}).items()}

    for arch in inp:
        a = inp[arch]
        cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")
        rows = slice(2 * half, 2 * half + 2)
        for mode in ("exact", "int8", "dtensor"):
            if mode == "dtensor" and arch != "olmoe-1b-7b":
                continue
            c = dataclasses.replace(cfg, moe_a2a_dtype="int8" if mode == "int8" else "bf16")
            p = {k: torch.tensor(v, requires_grad=True) for k, v in a["moe"].items() if k != "shared"}
            if "shared" in a["moe"]:
                p["shared"] = {k: torch.tensor(v, requires_grad=True) for k, v in a["moe"]["shared"].items()}
            flat = leaves(p)
            if mode == "dtensor":
                specs = moe.moe_params(c)
                placed = {k: shd.place(v.detach(), shd.sharding_for(specs[k].axes, v.shape, mesh, shd.TRAIN_RULES))
                          .requires_grad_() for k, v in flat.items()}
                x = shd.place(torch.tensor(a["x"]), shd.sharding_for(("batch", "seq", "act_embed"), a["x"].shape,
                              mesh, shd.TRAIN_RULES)).requires_grad_()
                g = shd.place(torch.tensor(a["g"]), shd.sharding_for(("batch", "seq", "act_embed"), a["g"].shape,
                              mesh, shd.TRAIN_RULES))
                p, flat = dict(placed), placed
            else:
                x = torch.tensor(a["x"][rows], requires_grad=True)
                g = torch.tensor(a["g"][rows])
            with shd.use_rules(mesh, shd.TRAIN_RULES):
                y, aux = moe.moe_apply(p, x, c)
            names = list(flat)
            grads = torch.autograd.grad((y * g).sum(), [x] + [flat[k] for k in names])
            if mode == "dtensor":
                y, grads = y.full_tensor(), [gr.full_tensor() for gr in grads]
            key = f"{arch}/{mode}"
            out[f"{key}/y"], out[f"{key}/aux"] = y.detach().numpy(), aux.detach().numpy()
            out[f"{key}/gx"] = grads[0].numpy()
            for k, gr in zip(names, grads[1:]):
                out[f"{key}/g.{k}"] = gr.numpy()
        if "full" in a:
            params = train_state_from_numpy(a["full"], a["full"], a["full"], 0, cfg=cfg, device="cpu").params
            api = build(cfg)
            batch = {k: torch.from_numpy(v[rows]) for k, v in a["batch"].items()}
            with shd.use_rules(mesh, shd.TRAIN_RULES), torch.no_grad():
                _, metrics = api.loss(ComputeView(params, torch.float32), batch)
            for k in ("nll", "moe_aux"):
                out[f"{arch}/full/{k}"] = metrics[k].numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    dist.barrier()  # no rank tears its group down while a peer's last exchange is in flight
    dist.destroy_process_group()
"""


def _cfg(arch):
    return dataclasses.replace(r_get_config(arch, reduced=True), compute_dtype="float32")


def _qdq(x):
    """The reference's ``_q_a2a`` row quantization without the exchange
    (an all-to-all moves whole rows)."""
    scale = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-8) / 127.0
    return jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8).astype(jnp.float32) * scale


def _ref_half(p, half, cfg, int8=False):
    """The reference's capacity dispatch on one token half (+ shared)."""
    b, s, d = half.shape
    flat = half.reshape(-1, d)
    if int8:  # the EP body's dataflow with the int8 exchanges as row round trips
        t = flat.shape[0]
        cap = max(((int(cfg.capacity_factor * t * cfg.top_k / cfg.num_experts) + 3) // 4) * 4, 4)
        buf, safe_e, pos, keep, weight, aux = r_moe._local_dispatch(p["router"], flat, cfg, cap)
        buf = _qdq(buf)
        h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", buf, p["w_gate"])) * jnp.einsum("ecd,edf->ecf", buf, p["w_up"])
        ob = _qdq(jnp.einsum("ecf,efd->ecd", h, p["w_down"]))
        ob = jnp.concatenate([ob, jnp.zeros((cfg.num_experts, 1, d), ob.dtype)], axis=1)
        y = (ob[safe_e, jnp.where(keep, pos, cap)].reshape(t, cfg.top_k, d) * weight[..., None]).sum(1)
    else:
        y, aux = r_moe._moe_capacity({k: v for k, v in p.items() if k != "shared"}, flat, cfg)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + r_mlp_apply(p["shared"], half, cfg)
    return y, aux


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    inputs, refs = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        p = r_materialize(r_moe.moe_params(cfg), jax.random.PRNGKey(i))
        x = (rng.standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32)
        g = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        inputs[arch] = {"moe": jax.tree.map(np.asarray, p), "x": x, "g": g}
        if cfg.first_dense:
            api = r_build(cfg)
            full = r_materialize(api.params_def, jax.random.PRNGKey(7))
            inputs[arch]["full"] = jax.tree.map(np.asarray, full)
            inputs[arch]["batch"] = r_synthetic_batch(api, RShape("t", S, B, "train"), 0)
        refs[arch] = p
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    run_ranks(RANK_CODE, 4, tmp)
    return inputs, refs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (what, err, scale)
    return err


def _ref_loss_and_grads(p, x, g, cfg):
    def loss(p, x):
        ys = [_ref_half(p, x[h * 2:h * 2 + 2], cfg)[0] for h in range(2)]
        return jnp.sum(jnp.concatenate(ys, 0) * g)
    return jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_output_and_aux_match_capacity_per_half(ranks, arch):
    inputs, refs, outs = ranks
    cfg, x = _cfg(arch), inputs[arch]["x"]
    halves = [_ref_half(refs[arch], jnp.asarray(x[h * 2:h * 2 + 2]), cfg) for h in range(2)]
    aux_mean = (float(halves[0][1]) + float(halves[1][1])) / 2
    for r in range(4):
        h = r // 2
        _close(outs[r][f"{arch}/exact/y"], halves[h][0], 1e-5, (arch, r))
        assert abs(float(outs[r][f"{arch}/exact/aux"]) - aux_mean) <= 1e-5 * max(1.0, aux_mean)


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_gradients_match_capacity_per_half(ranks, arch):
    inputs, refs, outs = ranks
    cfg = _cfg(arch)
    gp, gx = _ref_loss_and_grads(refs[arch], inputs[arch]["x"], jnp.asarray(inputs[arch]["g"]), cfg)
    for r in range(4):
        h = r // 2
        _close(outs[r][f"{arch}/exact/gx"], gx[h * 2:h * 2 + 2], 1e-4, (arch, "x", r))
    # expert weights: each rank's gradient covers its own experts (zeros
    # elsewhere); the router and the shared experts: one copy per token half
    for k in EXPERT:
        _close(sum(outs[r][f"{arch}/exact/g.{k}"] for r in range(4)), gp[k], 1e-4, (arch, k))
        for r in range(4):
            m, e_loc = r % 2, cfg.num_experts // 2
            others = np.delete(outs[r][f"{arch}/exact/g.{k}"], np.s_[m * e_loc:(m + 1) * e_loc], axis=0)
            assert not others.any(), (arch, k, r)
    _close(outs[0][f"{arch}/exact/g.router"] + outs[2][f"{arch}/exact/g.router"], gp["router"], 1e-4, (arch, "router"))
    np.testing.assert_array_equal(outs[0][f"{arch}/exact/g.router"], outs[1][f"{arch}/exact/g.router"])
    for k in gp.get("shared", {}):
        _close(outs[0][f"{arch}/exact/g.shared.{k}"] + outs[2][f"{arch}/exact/g.shared.{k}"], gp["shared"][k], 1e-4,
               (arch, "shared", k))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_ep_matches_row_quantized_dispatch(ranks, arch):
    inputs, refs, outs = ranks
    cfg, x = _cfg(arch), inputs[arch]["x"]
    for r in range(4):
        h = r // 2
        want, _ = _ref_half(refs[arch], jnp.asarray(x[h * 2:h * 2 + 2]), cfg, int8=True)
        got = outs[r][f"{arch}/int8/y"]
        _close(got, want, 1e-5, (arch, "int8", r))
        exact = outs[r][f"{arch}/exact/y"]
        # two row round trips, each within half a step of 1/127 of a row's amax
        assert float(np.abs(got - exact).max()) <= 2.0 / 127.0 * float(np.abs(exact).max()), (arch, r)
        assert float(np.abs(got - exact).max()) > 0


def test_ep_with_placed_tensors(ranks):
    inputs, refs, outs = ranks
    arch = "olmoe-1b-7b"
    cfg = _cfg(arch)
    x = inputs[arch]["x"]
    want = np.concatenate([np.asarray(_ref_half(refs[arch], jnp.asarray(x[h * 2:h * 2 + 2]), cfg)[0])
                           for h in range(2)])
    gp, gx = _ref_loss_and_grads(refs[arch], x, jnp.asarray(inputs[arch]["g"]), cfg)
    for r in range(4):
        _close(outs[r][f"{arch}/dtensor/y"], want, 1e-5, ("dtensor y", r))
        _close(outs[r][f"{arch}/dtensor/gx"], gx, 1e-4, ("dtensor x", r))
        for k in ("router",) + EXPERT:
            _close(outs[r][f"{arch}/dtensor/g.{k}"], gp[k], 1e-4, ("dtensor", k, r))


def test_deepseek_decoder_on_the_ep_path(ranks):
    inputs, _, outs = ranks
    arch = "deepseek-moe-16b"
    cfg = _cfg(arch)
    api = r_build(cfg)
    params = jax.tree.map(jnp.asarray, inputs[arch]["full"])
    metrics = [api.loss(params, {k: jnp.asarray(v[h * 2:h * 2 + 2]) for k, v in inputs[arch]["batch"].items()})[1]
               for h in range(2)]
    aux_mean = (float(metrics[0]["moe_aux"]) + float(metrics[1]["moe_aux"])) / 2
    for r in range(4):
        h = r // 2
        nll = float(metrics[h]["nll"])
        assert abs(float(outs[r][f"{arch}/full/nll"]) - nll) <= 1e-5 * max(1.0, nll), (r, nll)
        assert abs(float(outs[r][f"{arch}/full/moe_aux"]) - aux_mean) <= 1e-5 * max(1.0, aux_mean), r
