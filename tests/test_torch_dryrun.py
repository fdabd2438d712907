"""The dry run (``repro_torch.launch.dryrun``), the train step's abstract
twins and the hand kernels as custom ops, against the reference's
``repro.launch.dryrun`` / ``repro.training.train_step``.

- ``abstract_state`` leaf for leaf equal to the reference's (shape and
  dtype; a per-layer list's leaves with the stacked axis dropped) for all
  ten architectures;
- full-size cells on the (16, 16) pod, fake tensors only (a fake 256-rank
  world): internlm2-1.8b train_4k, olmoe-1b-7b train_4k under the EP rules,
  internlm2-1.8b prefill_32k and decode_32k, each with the custom ops its
  program calls; ``argument_bytes`` of the train cell equal to the sum of
  the reference's shard bytes (``spec_for`` on its abstract mesh, every
  leaf of its ``abstract_state`` and train batch), exactly;
  ``model_flops`` and ``param_count`` equal to the reference's; the
  record's keys the reference's (read from its source), plus the port's
  ``kernels``, ``device`` and ``collective_bytes_by_axis``.  Every library
  load is patched to raise while they trace, and no process group is left;
- the custom ops: each fake implementation gives its plain version's
  output shapes and dtypes; the flash and decode FLOP formulas equal
  ``launch.costs._attn_score_flops`` for one layer; a fake tensor reaches
  the op, a real CPU tensor the plain version;
- the counter's fidelity: on a reduced config the fake trace's FLOPs equal
  ``FlopCounterMode`` on a real step (the flash op on the path of both);
  the collective bytes the counter reads on the real placed step of 2 gloo
  ranks equal those it reads on the fake 2-rank trace, on meshes (2, 1)
  and (1, 2);
- ``maybe_remat``'s recompute runs under the forward's rule context when
  the backward runs on another thread (as the card's autograd engine does).

One module fixture traces the four pod cells once, each in a process of
its own, all at once (~40 s); the gloo ranks run once per module as
``python -c`` subprocesses under their own timeout.
"""

import ast
import dataclasses
import json
import math
import multiprocessing
import pathlib
import threading
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import get_shape as r_get_shape
from repro.distributed import sharding as r_shd
from repro.distributed.compat import abstract_mesh as r_abstract_mesh
from repro.models import build as r_build
from repro.models.model_zoo import model_flops as r_model_flops
from repro.models.model_zoo import spec_abstract as r_spec_abstract
from repro.models.model_zoo import spec_logical as r_spec_logical
from repro.training import optimizer as r_opt
from repro.training.train_step import abstract_state as r_abstract_state
from repro.training.train_step import state_logical as r_state_logical
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import disagg_solve as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import costs, dryrun
from repro_torch.models import build
from repro_torch.models.common import leaf_groups, maybe_remat
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import abstract_state

from test_torch_collectives import run_ranks  # one launcher for every rank group

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH, OLMOE = "internlm2-1.8b", "olmoe-1b-7b"
POD_CELLS = {"train": (ARCH, "train_4k", "train"), "ep": (OLMOE, "train_4k", "ep"),
             "prefill": (ARCH, "prefill_32k", "train"), "decode": (ARCH, "decode_32k", "train")}
_DTYPES = {jax.numpy.dtype("float32"): torch.float32, jax.numpy.dtype("int32"): torch.int32}


def _no_library(*_args, **_kwargs):
    raise AssertionError("a library was built or loaded while tracing on fake tensors")


def _forbid_build() -> None:
    """Every path to ``nvcc`` or ``ctypes`` raises (a worker's initializer)."""
    for mod in (kbuild, fa, da, rn, ds):
        mod.load_library = _no_library
    kbuild.compile_library = _no_library


def _trace_cell(cell: tuple) -> dict:
    arch, shape, rules = cell
    rec = dryrun.lower_cell(arch, shape, rules_name=rules)
    assert not dist.is_initialized() and not kbuild.built
    return rec


@pytest.fixture
def no_build(monkeypatch):
    """Every path to ``nvcc`` or ``ctypes`` raises."""
    for mod in (kbuild, fa, da, rn, ds):
        monkeypatch.setattr(mod, "load_library", _no_library)
    monkeypatch.setattr(kbuild, "compile_library", _no_library)


@pytest.fixture(scope="module")
def pod_records():
    """The four pod cells, each traced in a fresh process of its own (at
    once) whose every library load raises."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(POD_CELLS), mp_context=ctx, initializer=_forbid_build) as pool:
        return dict(zip(POD_CELLS, pool.map(_trace_cell, POD_CELLS.values())))


# --- abstract_state --------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_state_matches_reference(arch):
    for compress in (False, True):
        port = abstract_state(build(get_config(arch)), opt.OptimizerConfig(compress_grads=compress))
        want = r_abstract_state(r_build(r_get_config(arch)), r_opt.OptimizerConfig(compress_grads=compress))
        flat, _ = jax.tree_util.tree_flatten_with_path(want)
        want = {jax.tree_util.keystr(kp): leaf for kp, leaf in flat}
        got = leaf_groups(port)
        assert sorted(path for path, _, _ in got) == sorted(want), arch
        for path, leaves, stacked in got:
            shapes = {tuple(x.shape) for x in leaves}
            assert len(shapes) == 1 and len({x.dtype for x in leaves}) == 1, path
            shape = (len(leaves), *shapes.pop()) if stacked else tuple(leaves[0].shape)
            assert shape == tuple(want[path].shape), (path, shape, want[path].shape)
            assert leaves[0].dtype == _DTYPES[want[path].dtype], path


# --- the pod cells ---------------------------------------------------------


def _shard_bytes(spec, shape, itemsize, sizes) -> int:
    parts = 1
    for entry in spec:
        for axis in (entry,) if isinstance(entry, str) else tuple(entry or ()):
            parts *= sizes[axis]
    return math.prod(shape) // parts * itemsize


def test_train_argument_bytes_equal_reference_shards(pod_records):
    names, sizes = ("data", "model"), {"data": 16, "model": 16}
    r_mesh = r_abstract_mesh((16, 16), names)
    r_api, r_cfg = r_build(r_get_config(ARCH)), r_opt.OptimizerConfig()
    total = 0
    for logical, abstract in ((r_state_logical(r_api, r_cfg), r_abstract_state(r_api, r_cfg)),
                              (r_spec_logical(r_api.train_inputs(r_get_shape("train_4k"))),
                               r_spec_abstract(r_api.train_inputs(r_get_shape("train_4k"))))):
        axes = jax.tree_util.tree_leaves(logical, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
        leaves = jax.tree_util.tree_leaves(abstract)
        assert len(axes) == len(leaves)
        for ax, leaf in zip(axes, leaves):
            spec = r_shd.spec_for(ax, leaf.shape, r_mesh, r_shd.TRAIN_RULES)
            total += _shard_bytes(tuple(spec), leaf.shape, leaf.dtype.itemsize, sizes)
    assert pod_records["train"]["memory"]["argument_bytes"] == total


@pytest.mark.parametrize("cell", list(POD_CELLS))
def test_pod_cell_counts(pod_records, cell):
    rec = pod_records[cell]
    arch, shape, _ = POD_CELLS[cell]
    r_cfg = r_get_config(arch)
    assert rec["model_flops"] == r_model_flops(r_cfg, r_get_shape(shape))
    assert rec["param_count"] == r_cfg.param_count()
    layers = get_config(arch).num_layers
    # each layer's forward and its remat recompute, then its backward
    train = {"flash_attention_lse": 2 * layers, "flash_attention_bwd": layers}
    want = {"train": train, "ep": train,
            "prefill": {"flash_attention": layers}, "decode": {"decode_attention_lse": layers}}[cell]
    assert rec["kernels"] == want
    assert rec["mesh"] == "16x16" and rec["devices"] == 256 and rec["flops_per_device"] > 0
    coll = rec["collective_bytes"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total") == sum(
        rec["collective_bytes_by_axis"].values())
    assert rec["collective_bytes_structured"] == {"top": coll, "body": {}}
    assert ("all-to-all" in coll) == (cell == "ep")  # olmoe's experts exchange tokens over "model"
    mem = rec["memory"]
    assert mem["peak_bytes_est"] == mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"] - mem[
        "alias_bytes"]
    if rec["kind"] == "train":  # the parameters and moments are updated in place
        assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]


CARD_GIB = 79.18  # an H100 80GB's memory as torch reports it
UNSPLIT_DECODE_GIB = 53.3  # internlm2 decode_32k on the pod with the cache gathered over "model" (PERF.md)


def test_pod_cells_run_split_over_model(pod_records):
    """internlm2's train_4k fits a card on the pod once the logits and the
    products are split 16 ways; decode_32k reads its cache where it lies:
    this rank's block of 8 sequences x 2,048 rows (kv_seq over "model",
    since Hkv 8 does not divide 16), at least 3x below the gathered cache's
    peak."""
    cfg = get_config(ARCH)
    assert pod_records["train"]["memory"]["peak_bytes_est"] < CARD_GIB * 2**30
    dec = pod_records["decode"]["memory"]
    block = 2 * cfg.num_layers * (128 // 16) * (32768 // 16) * cfg.num_kv_heads * cfg.head_dim * 2  # k + v, bf16
    assert block <= dec["argument_bytes"] and dec["peak_bytes_est"] < UNSPLIT_DECODE_GIB / 3 * 2**30


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_split_flops_are_the_unsplit_flops_over_model_size(kind):
    """Reduced internlm2 (H 4, Hkv 2) traced on ("data", "model") = (1, 4)
    against the (1, 1) mesh: every product is split 4 ways -- the rank's
    one q head and the kv head it reads, a quarter of the MLP and of the
    vocabulary, a quarter of the decode cache's rows -- so no work is
    repeated across "model"."""
    shape = ShapeConfig("t", 16, 4, kind)
    overrides = _reduced_overrides(ARCH)
    split = dryrun.lower_cell(ARCH, shape, cfg_overrides=overrides, mesh=(1, 4))
    whole = dryrun.lower_cell(ARCH, shape, cfg_overrides=overrides, mesh="local")
    assert split["flops_per_device"] * 4 == whole["flops_per_device"] > 0
    assert split["kernels"] == ({"decode_attention_lse": 2} if kind == "decode" else whole["kernels"])


def _reference_record_keys() -> tuple[set, set]:
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "record":
            keys = {k.value for k in node.value.keys}
            memory = next(v for k, v in zip(node.value.keys, node.value.values) if k.value == "memory")
            return keys, {k.value for k in memory.keys}
    raise AssertionError("no record dict in the reference's dryrun.py")


def test_record_keys_are_the_reference_keys(pod_records):
    keys, memory = _reference_record_keys()
    for rec in pod_records.values():
        assert set(rec) - keys == {"kernels", "device", "collective_bytes_by_axis"}
        assert keys <= set(rec) and set(rec["memory"]) == memory


def test_fake_world_leaves_no_group_and_does_not_nest():
    with pytest.raises(ValueError, match="do not split"):  # fails inside the fake world
        dryrun.lower_cell(OLMOE, ShapeConfig("t", 16, 16, "train"), rules_name="ep", cfg_overrides={"num_experts": 8})
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="cannot nest"):
            dryrun.lower_cell(ARCH, "decode_32k")
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_cli_writes_one_record(tmp_path, capsys, no_build):
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert "OK  xlstm-350m_decode_32k_16x16" in capsys.readouterr().out
    rec = json.loads((tmp_path / "xlstm-350m_decode_32k_16x16.json").read_text())
    assert rec["kind"] == "decode" and rec["kernels"] == {} and rec["wall_s"] > 0


# --- the custom ops ---------------------------------------------------------


def _fake_like(mode, *tensors):
    return [mode.from_tensor(t) for t in tensors]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_ops_give_the_plain_versions_shapes(dtype):
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 40, 4, 16, generator=g, dtype=dtype), torch.randn(2, 56, 2, 16, generator=g, dtype=dtype)
    qd, kc = torch.randn(2, 4, 16, generator=g, dtype=dtype), torch.randn(2, 30, 2, 16, generator=g, dtype=dtype)
    lens = torch.tensor([3, 30], dtype=torch.int32)
    x, gamma = torch.randn(3, 5, 32, generator=g, dtype=dtype), torch.randn(32, generator=g)
    c, w = torch.rand(2, 3, 50, 8, generator=g), torch.rand(2, 3, 50, generator=g)
    cases = [
        (torch.ops.repro_torch.flash_attention, (q, k, k, True), ref.flash_attention(q, k, k, True)),
        (torch.ops.repro_torch.flash_attention_lse, (q, k, k, False), ref.flash_fwd(q, k, k, False)),
        (torch.ops.repro_torch.decode_attention, (qd, kc, kc, lens), ref.decode_attention(qd, kc, kc, lens)),
        (torch.ops.repro_torch.rmsnorm, (x, gamma, 1e-5), ref.rmsnorm(x, gamma)),
        (torch.ops.repro_torch.disagg_gram, (c, w), ref.disagg_gram(c, w)),
    ]
    with FakeTensorMode() as mode:
        for op, args, want in cases:
            fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
            got = op(*fake)
            got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
            assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want], op


def test_attention_flop_formulas_equal_the_cost_model():
    cfg = get_config(ARCH)
    b, s, h, hkv, d = 4, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    with FakeTensorMode():
        q, k = torch.empty(b, s, h, d), torch.empty(b, s, hkv, d)
        qd, kc = torch.empty(b, h, d), torch.empty(b, s, hkv, d)
        with FlopCounterMode(display=False) as fwd:
            torch.ops.repro_torch.flash_attention_lse(q, k, k, True)
        with FlopCounterMode(display=False) as plain:
            torch.ops.repro_torch.flash_attention(q, k, k, False)
        with FlopCounterMode(display=False) as dec:
            torch.ops.repro_torch.decode_attention(qd, kc, kc, torch.empty(b, dtype=torch.int32))
    assert fwd.get_total_flops() == costs._attn_score_flops(cfg, b * s, s, True)
    assert plain.get_total_flops() == costs._attn_score_flops(cfg, b * s, s, False)
    assert dec.get_total_flops() == costs._attn_score_flops(cfg, b, s, False)


def test_fake_tensors_reach_the_op_and_real_cpu_tensors_the_plain_version(monkeypatch, no_build):
    seen = []
    for name in ("flash_attention", "flash_fwd", "decode_attention", "rmsnorm", "disagg_gram"):
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=getattr(ref, name), **k: seen.append(_n) or _f(*a, **k))
    x, lens = torch.ones(1, 4, 2, 16), torch.ones(1, dtype=torch.int32)
    calls = lambda: [ops.flash_attention(x, x, x), ops.flash_attention(x.clone().requires_grad_(), x, x),  # noqa: E731
                     ops.decode_attention(x[:, 0], x, x, lens), ops.rmsnorm(x, torch.ones(16)),
                     ops.disagg_gram(x[0], x[0, ..., 0])]
    calls()
    assert set(seen) == {"flash_attention", "flash_fwd", "decode_attention", "rmsnorm", "disagg_gram"}
    seen.clear()
    with FakeTensorMode() as mode:
        x, lens = mode.from_tensor(x), mode.from_tensor(lens)
        calls()
    assert seen == []


# --- the counters' fidelity -------------------------------------------------


def _reduced_overrides(arch: str) -> dict:
    full, small = get_config(arch), get_config(arch, reduced=True)
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(full)
            if f.name != "name" and getattr(small, f.name) != getattr(full, f.name)}


def test_trace_flops_equal_a_real_step(monkeypatch):
    """Reduced internlm2 (remat "full" put back) on the (1, 1) mesh: the
    trace against one real step on the CPU, with the flash ops (the plain
    forward and backward registered as their CPU implementations) on both
    paths."""
    overrides = {**_reduced_overrides(ARCH), "remat": "full", "compute_dtype": "float32"}
    shape = ShapeConfig("t", 64, 2, "train")
    ocfg = opt.OptimizerConfig()
    rec = dryrun.lower_cell(ARCH, shape, opt_config=ocfg, cfg_overrides=overrides, mesh="local")
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.training.train_step import init_state, make_train_step

    lib = torch.library.Library("repro_torch", "IMPL")
    lib.impl("flash_attention_lse", lambda q, k, v, causal: ref.flash_fwd(q, k, v, causal), "CPU")
    lib.impl("flash_attention_bwd",
             lambda q, k, v, out, lse, dout, causal: ref.flash_bwd(q, k, v, out, lse, dout, causal), "CPU")
    monkeypatch.setattr(ops, "_kernel_path", lambda name, x: True)
    try:
        api = build(dataclasses.replace(get_config(ARCH), **overrides))
        state = init_state(api, torch.Generator().manual_seed(0), ocfg)
        batch = next(batch_iterator(api, shape, DataConfig(seed=0)))
        with FlopCounterMode(display=False) as counter:
            make_train_step(api, ocfg)(state, batch)
    finally:
        lib._destroy()
    assert rec["kernels"] == {"flash_attention_lse": 2 * api.cfg.num_layers, "flash_attention_bwd": api.cfg.num_layers}
    assert rec["flops_per_device"] == counter.get_total_flops() > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(t.numel() * t.element_size() for t in dryrun._leaves((state, batch)))
    assert mem["alias_bytes"] == 3 * sum(p.numel() * 4 for p in dryrun._leaves(state.params))


GLOO_MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
GLOO_SHAPE = (16, 4)  # seq, batch

RANK_CODE = f"""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import batch_shardings, init_state, jit_train_step, place_state

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{{tmp}}/store", world), rank=rank, world_size=world)
    api = build(get_config("{ARCH}", reduced=True))
    ocfg = opt.OptimizerConfig()
    shape = ShapeConfig("t", *{GLOO_SHAPE!r}, "train")
    out = {{}}
    for name, dims in {GLOO_MESHES!r}.items():
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        compile_for, st_sh = jit_train_step(api, ocfg, mesh, shd.TRAIN_RULES)
        step, specs = compile_for(shape)
        state = place_state(init_state(api, torch.Generator().manual_seed(0), ocfg), st_sh)
        batch = next(batch_iterator(api, shape, DataConfig(seed=0),
                                    shardings=batch_shardings(specs, mesh, shd.TRAIN_RULES)))
        with CollectiveCounter(mesh) as counter:
            step(state, batch)
        out[name] = dict(bytes=counter.collective_bytes(), by_axis=dict(counter.by_axis), calls=dict(counter.calls))
    with open(f"{{tmp}}/rank{{rank}}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()  # no rank tears its group down while a peer's last exchange is in flight
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_gloo")
    run_ranks(RANK_CODE, 2, tmp, timeout=240.0)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("mesh", list(GLOO_MESHES))
def test_collective_bytes_equal_two_gloo_ranks(gloo_counts, mesh):
    rec = dryrun.lower_cell(ARCH, ShapeConfig("t", *GLOO_SHAPE, "train"), cfg_overrides=_reduced_overrides(ARCH),
                            mesh=GLOO_MESHES[mesh])
    assert rec["devices"] == 2 and rec["mesh"] == mesh
    for rank in gloo_counts:
        assert rank[mesh]["bytes"] == rec["collective_bytes"]
        assert rank[mesh]["by_axis"] == rec["collective_bytes_by_axis"]
    assert rec["collective_bytes"]["total"] > 0


# --- the rule context in the remat recompute -------------------------------


def test_remat_recompute_keeps_the_rule_context():
    """The backward runs on another thread (the card's autograd engine
    does): the recompute must still see the forward's (mesh, rules)."""
    seen = []

    def fn(x):
        seen.append(shd._active())
        return torch.sin(x)

    x = torch.ones(3, requires_grad=True)
    marker = object()
    with shd.use_rules(marker, shd.TRAIN_RULES):
        y = maybe_remat(fn, "full")(x).sum()
    grads = []
    worker = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y, x)[0]))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(grads) == 1
    assert [a[0] if a else None for a in seen] == [marker, marker]
    np.testing.assert_allclose(grads[0].numpy(), np.cos(1.0) * np.ones(3), rtol=1e-6)
