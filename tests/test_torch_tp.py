"""The products split over "model" (``distributed.tensor_parallel``, the
``split`` mode of ``sharding.local_view``) against the port's one-process
unsplit program, on gloo ranks on the CPU, fp32.

Two rank groups run at once, each once for the module: 2 ranks on the mesh
("data", "model") = (1, 2) and 4 ranks on (1, 4).  Each case's weights are
drawn with numpy from a seed and come over with ``convert``; every rank
loads the same arrays.  On each mesh:

- the placed train step under ``TRAIN_RULES`` (one AdamW step): the loss,
  the metrics, every parameter after the step and the gradients (the first
  moment) against ``make_train_step`` on one process;
- reduced internlm2 (H 4, Hkv 2: at "model" 4 Hkv does not divide),
  reduced nemotron (6 heads: at 4 H does not divide, its flat 96 does), a
  vocabulary that does not divide (``vocab_pad_multiple`` 1), tied
  embeddings with the chunked CE, olmoe on the EP path, deepseek's dense
  layer 0 and shared experts, seamless's encoder-decoder, zamba2 (8 Mamba2
  heads, split), zamba2 at ``ssm_head_dim`` 64 (2 Mamba2 heads: at "model"
  4 they do not divide, its ``d_inner`` of 128 does), xlstm (2 heads: the
  mLSTM on its heads at 2, on its channels at 4; the sLSTM's input product
  split), the int8 cache on internlm2 (serve: kv heads at 2, kv_seq at 4),
  reduced qwen2.5 (5 heads over Hkv 1, the QKV biases split with their
  columns; its cache on kv_seq at 2 and 4);
- under ``SERVE_RULES``: the prefill's logits (gathered over "model") and
  the cache block each rank keeps (its kv heads, or its rows; zamba2's SSM
  state on its heads and conv tail on its channels; the mLSTM's memory on
  its heads), then three decode steps over a cache placed from the unsplit
  prefill, split on kv_seq at "model" 4 with one block that no step
  reaches; the widths of the leaves each rank read, and the collectives of
  a prefill, as many for S tokens as for S / 2 (none a token);
- a remat backward run on another thread (the card's autograd engine runs
  it on its own), its gradients against the unsplit ones.

All at ``max|split - ref| <= 1e-5 * max(1, max|ref|)``.  The reference's
own prefill logits (``repro``, under ``jax``) are held against the
one-process ones (internlm2) and the split ones (zamba2, xlstm), through
the same numpy weights.
"""

import dataclasses
import functools
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.models import build as r_build
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.distributed.checkpoint import host_arrays
from repro_torch.models import build
from repro_torch.kernels import ref as kref
from repro_torch.models.attention import merge_partials
from repro_torch.models.common import ComputeView, logical_axes, split_mask, tree_leaves
from repro_torch.models.model_zoo import extend_cache
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import make_train_step

from test_torch_collectives import run_ranks  # one launcher for every rank group

B, S, STEPS, S_MAX = 2, 8, 3, 16
PROMPT = 6  # the decode case's prompt: rows 6, 7, 8 are written, the last block of 4 never
#: AdamW's first step moves a weight by lr * g / (|g| + eps): at the
#: default eps 1e-8 that is lr * sign(g), so a last-bit difference in a
#: gradient element near 0 moves the weight by up to 2 lr.  The gradients
#: themselves are held through the first moment; eps 1e-3 keeps the update
#: a continuous function of them, so the weights after the step can be held
#: at the same 1e-5.
OCFG = dict(total_steps=10, warmup_steps=1, eps=1e-3)

#: name -> (arch, ArchConfig overrides, what runs)
CASES = {
    "internlm2": ("internlm2-1.8b", {}, ("train", "serve", "remat")),
    "nemotron": ("nemotron-4-15b", {}, ("train", "serve")),
    "vocab": ("internlm2-1.8b", {"vocab_size": 255, "vocab_pad_multiple": 1}, ("train", "serve")),
    "tied": ("internlm2-1.8b", {"tie_embeddings": True, "ce_chunk": 4}, ("train",)),
    "olmoe": ("olmoe-1b-7b", {"capacity_factor": 8.0}, ("train",)),
    "deepseek": ("deepseek-moe-16b", {"capacity_factor": 8.0}, ("train",)),
    "seamless": ("seamless-m4t-large-v2", {}, ("train", "serve")),
    "zamba2": ("zamba2-7b", {}, ("train", "serve")),
    "xlstm": ("xlstm-350m", {}, ("train", "serve")),
    "zamba2_hd64": ("zamba2-7b", {"ssm_head_dim": 64}, ("train", "serve")),
    "int8": ("internlm2-1.8b", {"kv_cache_dtype": "int8"}, ("serve",)),
    "qwen": ("qwen2.5-14b", {}, ("train", "serve")),
}
MESHES = {2: (1, 2), 4: (1, 4)}
#: Cases run on some of the meshes only: zamba2 at ``ssm_head_dim`` 64 is
#: the Mamba2 block whose heads do not divide the "model" size, which only
#: the (1, 4) mesh gives (at (1, 2) its 2 heads divide, as zamba2's 8 do).
#: Its reduced model's fp32 rounding reaches this file's bound, ~1e-5 of
#: scale, in its last layers: at (1, 2) the split and one-process programs
#: differ by about that, though against a float64 run of the same step the
#: split one is the closer of the two.
CASE_MESHES = {"zamba2_hd64": (4,)}


def _cfg(name: str, get=get_config):
    arch, changes, _ = CASES[name]
    return dataclasses.replace(get(arch, reduced=True), compute_dtype="float32", remat="none", **changes)


def _weights(api, seed: int) -> dict:
    """Numpy weights for the reference's stacked tree: each leaf drawn by
    its ``Param``'s law (normal with its std, the embedding's scale), and
    the ``zeros``/``ones`` leaves moved off their constants a little so
    that every product and bias carries a gradient."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("zeros", "ones"):
            return (float(p.init == "ones") + 0.05 * rng.standard_normal(p.shape)).astype(np.float32)
        if p.init == "embed":
            return (p.scale * rng.standard_normal(p.shape)).astype(np.float32)
        fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2 else p.shape[-1])
        return (p.scale / np.sqrt(fan_in) * rng.standard_normal(p.shape)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(v) for k, v in sorted(node.items())}

    return walk(api.params_def)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _inputs(api, cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)}
    out["labels"][0, :2] = -1  # ignored positions
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
    return out


RANK_CODE = """
    import dataclasses, json, sys, threading
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import params_from_numpy, train_state_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.checkpoint import host_arrays
    from repro_torch.models import build
    from repro_torch.models.common import ComputeView, layer_specs, leaf_groups, logical_axes, split_mask, tree_leaves
    from repro_torch.models.model_zoo import extend_cache
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step, place_state, state_shardings

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank, world_size=world)
    spec = json.load(open(f"{tmp}/cases.json"))
    mesh = init_device_mesh("cpu", tuple(spec["meshes"][str(world)]), mesh_dim_names=("data", "model"))
    out = {}

    def nested(flat):
        tree = {}
        for key, v in flat.items():
            node = tree
            *path, last = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = v
        return tree

    def gathered(x):  # a vocab block of logits -> the whole vocabulary
        axis = tp.model_axis()
        return x if axis is None or x.shape[-1] == cfg.padded_vocab else tp.gather_from_model(x, axis, -1)

    collectives = [0]
    for fn in ("_all_reduce", "_all_gather"):
        def counted(*a, _fn=getattr(tp, fn), **k):
            collectives[0] += 1
            return _fn(*a, **k)
        setattr(tp, fn, counted)

    def split_dim(block, whole):  # the dim the rank holds a block of, or -1
        diff = [i for i, (a, b) in enumerate(zip(block.shape, whole.shape)) if a != b]
        return diff[0] if diff else -1

    for name, (arch, changes, runs) in spec["cases"].items():
        if world not in spec["case_meshes"].get(name, [world]):
            continue
        cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32", remat="none", **changes)
        api = build(cfg)
        w = nested(dict(np.load(f"{tmp}/{name}_weights.npz")))
        inp = dict(np.load(f"{tmp}/{name}_inputs.npz"))
        batch = {"tokens": torch.from_numpy(inp["tokens"]), "labels": torch.from_numpy(inp["labels"])}
        if "src_embeds" in inp:
            batch["src_embeds"] = torch.from_numpy(inp["src_embeds"])
        logical = logical_axes(api.params_def)
        zeros = {k: np.zeros_like(v) for k, v in np.load(f"{tmp}/{name}_weights.npz").items()}
        if "train" in runs:
            ocfg = opt.OptimizerConfig(**spec["ocfg"])
            st_sh = state_shardings(api, ocfg, mesh, shd.TRAIN_RULES)
            state = place_state(train_state_from_numpy(w, nested(zeros), nested(zeros), 0, cfg=cfg, device="cpu"),
                                st_sh)
            placed = {k: shd.place(v, shd.sharding_for(("batch",) + (None,) * (v.ndim - 1), v.shape, mesh,
                                                       shd.TRAIN_RULES)) for k, v in batch.items()}
            with shd.use_rules(mesh, shd.TRAIN_RULES):
                state, metrics = make_train_step(api, ocfg)(state, placed)
            for k, v in metrics.items():
                out[f"{name}/train/metric/{k}"] = v.detach().numpy()
            for k, v in host_arrays(state).items():
                out[f"{name}/train/state{k}"] = v
        if "remat" in runs:
            rcfg = dataclasses.replace(cfg, remat="full")
            rapi = build(rcfg)
            ocfg = opt.OptimizerConfig(**spec["ocfg"])
            state = place_state(train_state_from_numpy(w, nested(zeros), nested(zeros), 0, cfg=rcfg, device="cpu"),
                                state_shardings(rapi, ocfg, mesh, shd.TRAIN_RULES))
            with shd.use_rules(mesh, shd.TRAIN_RULES):
                local = shd.local_view(state.params, logical, mesh, split=split_mask(logical))
                loss, _ = rapi.loss(ComputeView(local, torch.float32), batch)
            leaves = tree_leaves(state.params)
            grads = []
            worker = threading.Thread(target=lambda: grads.append(torch.autograd.grad(loss, leaves)))
            worker.start()
            worker.join(timeout=120)
            assert len(grads) == 1
            for i, g in enumerate(grads[0]):
                out[f"{name}/remat/grad{i}"] = g.full_tensor().numpy()
        if "serve" in runs:
            params = params_from_numpy(w, cfg, device="cpu")
            whole = params_from_numpy(w, cfg, device="cpu")
            shd.place_tree(params, shd.tree_shardings(logical, layer_specs(api.params_def), mesh, shd.SERVE_RULES))
            pre = {k: v for k, v in batch.items() if k != "labels"}
            with torch.no_grad():
                with shd.use_rules(mesh, shd.SERVE_RULES):
                    local = shd.local_view(params, logical, mesh, split=split_mask(logical))
                    for n_tok in (pre["tokens"].shape[1] // 2, pre["tokens"].shape[1]):
                        collectives[0] = 0
                        logits, cache = api.prefill(local, {k: v[:, :n_tok] for k, v in pre.items()})
                        out[f"{name}/collectives/{n_tok}"] = np.array(collectives[0])
                    for path, leaves, _ in leaf_groups(local):
                        out[f"{name}/shape{path}"] = np.array(leaves[0].shape)
                    out[f"{name}/logits_width"] = np.array(logits.shape[-1])
                    out[f"{name}/prefill/logits"] = gathered(logits).numpy()
                # the decode: the unsplit prefill of PROMPT tokens, its cache grown to S_MAX and placed
                small = {k: v[:, :spec["prompt"]] for k, v in pre.items()}
                _, c_whole = api.prefill(whole, small)
                _, c_full = api.prefill(whole, pre)
                c_whole = extend_cache(api, c_whole, spec["s_max"] - spec["prompt"])
                shape = ShapeConfig("d", spec["s_max"], pre["tokens"].shape[0], "decode")
                axes = {k: s.axes for k, s in api.cache_spec(shape).items()}
                placed = {k: shd.place(v, shd.sharding_for(axes[k], v.shape, mesh, shd.SERVE_RULES))
                          for k, v in c_whole.items()}
                steps = torch.from_numpy(inp["steps"])
                with shd.use_rules(mesh, shd.SERVE_RULES):
                    c_loc = shd.local_view(placed, axes, mesh, split=split_mask(axes))
                    for k, v in cache.items():  # the prefill's cache block, and the dim it is a block of
                        out[f"{name}/prefill/cache/{k}/r{rank}"] = v.float().numpy()
                        out[f"{name}/prefill/cache/{k}/r{rank}/dim"] = np.array(split_dim(v, c_full[k]))
                    for i, tok in enumerate(steps):
                        lg, c_loc = api.decode(local, c_loc, tok, spec["prompt"] + i)
                        out[f"{name}/decode/logits{i}"] = gathered(lg).numpy()
                    for k, v in c_loc.items():
                        out[f"{name}/decode/cache/{k}/r{rank}"] = v.float().numpy()
                        out[f"{name}/decode/cache/{k}/r{rank}/dim"] = np.array(split_dim(v, c_whole[k]))
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    dist.barrier()  # no rank tears its group down while a peer's last exchange is in flight
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both rank groups at once; returns {world: (tmp, [each rank's arrays])}."""
    spec = {"cases": {n: list(c) for n, c in CASES.items()}, "meshes": {str(k): v for k, v in MESHES.items()},
            "case_meshes": CASE_MESHES,
            "ocfg": OCFG, "prompt": PROMPT, "s_max": S_MAX}
    dirs = {}
    for world in MESHES:
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        for seed, name in enumerate(CASES):
            api = build(_cfg(name))
            np.savez(tmp / f"{name}_weights.npz", **_flat(_weights(api, seed)))
            np.savez(tmp / f"{name}_inputs.npz", **_inputs(api, api.cfg, 100 + seed))
        (tmp / "cases.json").write_text(json.dumps(spec))
        dirs[world] = tmp
    errors = []

    def group(world):
        try:
            run_ranks(RANK_CODE, world, dirs[world], timeout=300.0)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=group, args=(w,)) for w in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {w: [dict(np.load(dirs[w] / f"rank{r}.npz")) for r in range(w)] for w in MESHES}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= 1e-5 * scale, (what, err, scale)


def _case_inputs(name: str):
    cfg = _cfg(name)
    api = build(cfg)
    seed = list(CASES).index(name)
    return cfg, api, _weights(api, seed), _inputs(api, cfg, 100 + seed)


def _batch(inp: dict, labels: bool = True) -> dict:
    keys = ("tokens", "labels", "src_embeds") if labels else ("tokens", "src_embeds")
    return {k: torch.from_numpy(inp[k]) for k in keys if k in inp}


@functools.lru_cache(maxsize=None)
def _one_process(name: str) -> dict:
    """The unsplit program on one process: the train step's state and
    metrics, the prefill and the decode steps, the loss's gradients."""
    cfg, api, w, inp = _case_inputs(name)
    zeros = jax.tree.map(np.zeros_like, w)
    runs = CASES[name][2]
    out = {}
    if "train" in runs:
        state = train_state_from_numpy(w, zeros, zeros, 0, cfg=cfg, device="cpu")
        state, metrics = make_train_step(api, opt.OptimizerConfig(**OCFG))(state, _batch(inp))
        out["metrics"] = {k: v.detach().numpy() for k, v in metrics.items()}
        out["state"] = host_arrays(state)
    if "remat" in runs:
        params = train_state_from_numpy(w, zeros, zeros, 0, cfg=cfg, device="cpu").params
        loss, _ = api.loss(ComputeView(params, torch.float32), _batch(inp))
        out["grads"] = [g.numpy() for g in torch.autograd.grad(loss, tree_leaves(params))]
    if "serve" in runs:
        params = params_from_numpy(w, cfg, device="cpu")
        pre = _batch(inp, labels=False)
        with torch.no_grad():
            logits, cache = api.prefill(params, pre)
            out["prefill"] = (logits.numpy(), {k: v.float().numpy() for k, v in cache.items()})
            _, c = api.prefill(params, {k: v[:, :PROMPT] for k, v in pre.items()})
            c = extend_cache(api, c, S_MAX - PROMPT)
            out["decode"] = []
            for i, tok in enumerate(torch.from_numpy(inp["steps"])):
                lg, c = api.decode(params, c, tok, PROMPT + i)
                out["decode"].append(lg.numpy())
            out["decode_cache"] = {k: v.float().numpy() for k, v in c.items()}
    return out


def _cases(run: str) -> list:
    return [pytest.param(w, n, id=f"{n}-1x{w}") for w in MESHES for n, c in CASES.items()
            if run in c[2] and w in CASE_MESHES.get(n, MESHES)]


@pytest.mark.parametrize(("world", "name"), _cases("train"))
def test_train_step_matches_one_process(ranks, world, name):
    """Loss and metrics, every parameter after one AdamW step, and the
    gradients (``mu / (1 - b1)``) and ``sqrt(nu)`` at the gradients'
    scale, on every rank."""
    want = _one_process(name)
    beta1, beta2 = opt.OptimizerConfig().beta1, opt.OptimizerConfig().beta2
    grads = {k: v / (1 - beta1) for k, v in want["state"].items() if k.startswith(".opt.mu")}
    g_scale = max(float(np.abs(v).max()) for v in grads.values())
    for out in ranks[world]:
        for k, v in want["metrics"].items():
            _close(out[f"{name}/train/metric/{k}"], v, k)
        for k, v in want["state"].items():
            got = out[f"{name}/train/state{k}"]
            if k.startswith(".opt.mu"):
                _close(got / (1 - beta1) / g_scale, v / (1 - beta1) / g_scale, k)
            elif k.startswith(".opt.nu"):
                _close(np.sqrt(got / (1 - beta2)) / g_scale, np.sqrt(v / (1 - beta2)) / g_scale, k)
            else:
                _close(got, v, k)


def _block(whole: np.ndarray, dim: int, world: int, rank: int) -> np.ndarray:
    return whole if dim < 0 else np.split(whole, world, axis=dim)[rank]


@pytest.mark.parametrize(("world", "name"), _cases("serve"))
def test_prefill_logits_and_cache_blocks(ranks, world, name):
    logits, cache = _one_process(name)["prefill"]
    for rank, out in enumerate(ranks[world]):
        _close(out[f"{name}/prefill/logits"], logits, "logits")
        for k, v in cache.items():
            dim = int(out[f"{name}/prefill/cache/{k}/r{rank}/dim"])
            _close(out[f"{name}/prefill/cache/{k}/r{rank}"], _block(v, dim, world, rank), k)


def _model_widths(cfg, world: int) -> dict:
    """The shapes a rank reads of the split leaves (first layer's), by the
    reference's ``keystr`` path: 1 / M blocks where the dim divides."""
    def part(n, parts=1):  # a "model" block of each of ``parts`` groups, or the whole dim
        return n // world if (n // parts) % world == 0 else n

    d, v = cfg.d_model, cfg.padded_vocab
    out = {"['embed']": (part(v), d)}
    if cfg.family == "hybrid":
        di, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
        mb = "['layers']['mamba']"
        out.update({f"{mb}['w_zx']": (d, part(2 * di, 2)), f"{mb}['w_bc']": (d, part(2 * h * n, 2)),
                    f"{mb}['w_dt']": (d, part(h)), f"{mb}['a_log']": (part(h),),
                    f"{mb}['conv_w']": (cfg.ssm_conv, part(di)), f"{mb}['gamma_gate']": (part(di),),
                    f"{mb}['w_out']": (part(di), d), "['shared']['attn']['wq']": (d, part(cfg.q_dim))})
    elif cfg.family == "ssm":
        di, h = 2 * d, cfg.num_heads
        out.update({"['pairs']['m']['w_in']": (d, part(2 * di, 2)),
                    "['pairs']['m']['w_qkv']": (part(h), di // h, 3 * di // h),
                    "['pairs']['m']['w_if']": (part(di), 2 * h), "['pairs']['m']['b_if']": (part(2 * h, 2),),
                    "['pairs']['m']['gamma']": (part(di),), "['pairs']['m']['w_out']": (part(di), d),
                    "['pairs']['s']['w_x']": (d, part(4 * d)), "['pairs']['s']['w_out']": (d, d),
                    "['pairs']['s']['gamma']": (d,)})
    else:
        attn = "['dec_layers']['attn']" if cfg.family == "encdec" else "['layers']['attn']"
        out.update({f"{attn}['wq']": (d, part(cfg.q_dim)), f"{attn}['wo']": (part(cfg.q_dim), d)})
    return out


@pytest.mark.parametrize(("world", "name"), _cases("serve"))
def test_split_leaves_are_model_blocks(ranks, world, name):
    """The serve program read ``wq``, ``wo``, the embedding, the Mamba2
    and mLSTM leaves and the sLSTM's ``w_x`` as 1 / M blocks (a fused
    leaf's block of each group) and made the logits as one; a dim that does
    not divide stays whole, and so do the sLSTM's recurrence, norm and
    ``w_out``."""
    cfg = _cfg(name)
    v = cfg.padded_vocab if cfg.padded_vocab % world else cfg.padded_vocab // world
    for out in ranks[world]:
        assert int(out[f"{name}/logits_width"]) == v
        for path, shape in _model_widths(cfg, world).items():
            assert tuple(out[f"{name}/shape{path}"]) == shape, (path, out[f"{name}/shape{path}"], shape)


@pytest.mark.parametrize(("world", "name"), _cases("serve"))
def test_no_collective_a_token(ranks, world, name):
    """A prefill makes as many collectives for S tokens as for S / 2: none
    sits in a per-token loop (the sLSTM's recurrence)."""
    s = _case_inputs(name)[3]["tokens"].shape[1]
    for out in ranks[world]:
        assert int(out[f"{name}/collectives/{s}"]) == int(out[f"{name}/collectives/{s // 2}"]) > 0


@pytest.mark.parametrize(("world", "name"), _cases("serve"))
def test_decode_over_the_cache_where_it_lies(ranks, world, name):
    """Three steps; a dense cache whose kv heads do not divide "model" is
    split on kv_seq (reduced internlm2's and nemotron's Hkv 2 at 4, in
    blocks of 4 rows, the last holding no live row in any step; reduced
    qwen's Hkv 1 at 2 and 4), else on its kv heads."""
    want = _one_process(name)
    cfg = _cfg(name)
    dims = set()
    for rank, out in enumerate(ranks[world]):
        for i, lg in enumerate(want["decode"]):
            _close(out[f"{name}/decode/logits{i}"], lg, f"step {i}")
        for k, v in want["decode_cache"].items():
            dim = int(out[f"{name}/decode/cache/{k}/r{rank}/dim"])
            dims.add((k, dim))
            _close(out[f"{name}/decode/cache/{k}/r{rank}"], _block(v, dim, world, rank), k)
    if cfg.family == "dense" and cfg.num_kv_heads % world:  # Hkv does not divide "model": the rows are split
        assert ("k", 2) in dims and PROMPT + STEPS <= 3 * S_MAX // world
    elif cfg.family == "dense":  # Hkv divides "model": the kv heads are
        assert ("k", 3) in dims


@pytest.mark.parametrize("world", list(MESHES))
def test_remat_backward_on_another_thread(ranks, world):
    want = _one_process("internlm2")["grads"]
    scale = max(float(np.abs(g).max()) for g in want)
    for out in ranks[world]:
        for i, g in enumerate(want):
            _close(out[f"internlm2/remat/grad{i}"] / scale, g / scale, f"leaf {i}")


def test_split_prefill_logits_match_the_reference():
    """The reference's own prefill on the same numpy weights and tokens."""
    _close(_one_process("internlm2")["prefill"][0], _reference_prefill("internlm2"), "one process")


@functools.lru_cache(maxsize=None)
def _reference_prefill(name: str) -> np.ndarray:
    """The reference's own prefill logits (``repro``, under ``jax``) of a
    case's numpy weights and tokens."""
    cfg, _, w, inp = _case_inputs(name)
    arch, changes, _ = CASES[name]
    r_cfg = dataclasses.replace(r_get_config(arch, reduced=True), compute_dtype="float32", remat="none", **changes)
    assert cfg.padded_vocab == r_cfg.padded_vocab
    r_logits, _ = jax.jit(r_build(r_cfg).prefill)(jax.tree.map(jnp.asarray, w), {"tokens": jnp.asarray(inp["tokens"])})
    return np.asarray(r_logits)


@pytest.mark.parametrize(("world", "name"), [pytest.param(w, n, id=f"{n}-1x{w}") for w in MESHES
                                             for n in ("zamba2", "zamba2_hd64", "xlstm")
                                             if w in CASE_MESHES.get(n, MESHES)])
def test_split_prefill_logits_match_the_reference_per_family(ranks, world, name):
    """The recurrent families' split prefill logits, on every rank, against
    the reference's own prefill."""
    want = _reference_prefill(name)
    for out in ranks[world]:
        _close(out[f"{name}/prefill/logits"], want, "split")


def test_split_mask_keys_the_recurrent_blocks_by_path():
    """The Mamba2 and mLSTM leaves split (the fused ones by their groups),
    the sLSTM's input product alone of its block; ``gamma`` and ``w_out``
    split in an mLSTM and stay whole in an sLSTM; the router stays whole;
    the recurrent caches on heads or channels and the int8 scales split."""
    hybrid = split_mask(logical_axes(build(_cfg("zamba2")).params_def))
    assert hybrid["layers"][0]["mamba"] == {"w_zx": 2, "w_bc": 2, "w_dt": 1, "dt_bias": 1, "a_log": 1, "d_skip": 1,
                                            "conv_w": 1, "conv_b": 1, "gamma_gate": 1, "w_out": 1}
    assert hybrid["layers"][0]["ln"] == 0 and hybrid["shared"]["attn"]["wq"] == 1
    pair = split_mask(logical_axes(build(_cfg("xlstm")).params_def))["pairs"][0]
    assert pair["m"] == {"ln": 0, "w_in": 2, "w_qkv": 1, "w_if": 1, "b_if": 2, "gamma": 1, "w_out": 1}
    assert pair["s"] == {"ln": 0, "w_x": 1, "r": 0, "b": 0, "gamma": 0, "w_out": 0}
    moe = split_mask(logical_axes(build(_cfg("olmoe")).params_def))["layers"][0]["mixer"]
    assert moe["router"] == 0 and moe["w_up"] == 0
    caches = {"ssm_h": 1, "conv": 1, "m": 1, "s_c": 0, "k_scale": 1, "attn_k": 1}
    assert split_mask({k: ("batch",) for k in caches}) == caches


@pytest.mark.parametrize("blocks", [2, 4])
def test_int8_decode_merged_over_row_blocks(blocks):
    """The int8 cache split on kv_seq: each block's plain quant attention
    with its log-sum-exp, merged, against the whole cache's (one block past
    every length)."""
    rng = np.random.default_rng(7)
    b, rows, h, hkv, d = 3, 16, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    (kq, ks), (vq, vs) = (kref.quantize_kv(torch.from_numpy(rng.standard_normal((b, rows, hkv, d))
                                                            .astype(np.float32))) for _ in range(2))
    lengths = torch.tensor([rows, rows // 2 + 1, 3], dtype=torch.int32)
    want = kref.decode_attention_quant(q, kq, vq, ks, vs, lengths)
    n = rows // blocks
    parts = [kref.decode_attention_quant(q, *(x[:, r * n:(r + 1) * n] for x in (kq, vq, ks, vs)),
                                         torch.clamp(lengths - r * n, 0, n).to(torch.int32), return_lse=True)
             for r in range(blocks)]
    got = merge_partials(torch.stack([o for o, _ in parts]), torch.stack([lse for _, lse in parts]))
    assert bool(torch.isinf(parts[-1][1][2]).all())  # the last block holds no live row of sequence 2
    _close(got.numpy(), want.numpy(), "merged")
