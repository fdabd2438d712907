"""The train state placed on a mesh (``training.train_step``'s
``state_shardings`` / ``place_state``, ``data.pipeline.batch_iterator
(shardings=)``, ``distributed.checkpoint``'s placed save and re-shard
restore) on one group of 2 gloo ranks, reduced internlm2-1.8b in fp32.

On each of the meshes (2, 1) and (1, 2) ("data", "model"):

- one placed train step against the one-process step on the same initial
  state and batch: the loss at 1e-5 of scale, the gradients (read from the
  first moment, ``mu = (1 - b1) g``) at 1e-4 of scale, the second moment
  likewise;
- the placed batch is the reference's synthetic batch bit for bit, and each
  rank holds its block of it;
- a checkpoint written by the reference restores onto the 2-rank sharding
  bitwise, and the placed state's save writes the reference's files (the
  same manifest index, leaf names and bytes);
- ``test_elastic_reshard_roundtrip`` mirrored: the (2, 1) state's
  checkpoint restores onto the (1, 2) mesh bitwise;
- reduced olmoe-1b-7b's placed step on (1, 2), its MoE layers on the EP
  path (an exchange over "model"), against the one-process step;
- ``launch.train.main`` on the two ranks (``--mesh local``: (2, 1)),
  checkpointing, and a relaunch that resumes from the step before the lost
  last checkpoint and repeats the first run's losses and state bitwise.

In this process: the one-device branch of ``place_state`` (plain tensors,
the same objects) and ``--mesh pod`` / ``multipod`` raising with the rank
count they need.  One rank group for the module (``FileStore`` rendezvous,
``python -c`` subprocesses under their own timeout).
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import ShapeConfig as RShape
from repro.data.pipeline import synthetic_batch as r_synthetic_batch
from repro.distributed.checkpoint import save_checkpoint as r_save_checkpoint
from repro.models import build as r_build
from repro.training import optimizer as r_opt
from repro.training.train_step import init_state as r_init_state
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpoint import host_arrays
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as t_train
from repro_torch.models import build
from repro_torch.models.common import tree_leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import init_state, make_train_step, place_state, state_shardings

from test_torch_collectives import run_ranks  # one launcher for every rank group

ARCH, B, S = "internlm2-1.8b", 4, 16
MESHES = {"2x1": (2, 1), "1x2": (1, 2)}


RANK_CODE = f"""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_iterator, synthetic_batch
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (
        batch_shardings, init_state, make_train_step, place_state, state_shardings)

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{{tmp}}/store", world), rank=rank, world_size=world)
    cfg = dataclasses.replace(get_config("{ARCH}", reduced=True), compute_dtype="float32")
    api = build(cfg)
    ocfg = opt.OptimizerConfig(total_steps=10, warmup_steps=1)
    shape = ShapeConfig("t", {S}, {B}, "train")
    out, first = {{}}, None
    for name, dims in {MESHES!r}.items():
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        st_sh = state_shardings(api, ocfg, mesh, shd.TRAIN_RULES)
        b_sh = batch_shardings(api.train_inputs(shape), mesh, shd.TRAIN_RULES)
        state = place_state(init_state(api, torch.Generator().manual_seed(0), ocfg), st_sh)
        assert all(isinstance(x, DTensor) for x in tree_leaves(state.params) + tree_leaves(state.opt.mu))
        assert not isinstance(state.opt.count, DTensor)
        batch = next(batch_iterator(api, shape, DataConfig(seed=0), shardings=b_sh))
        host = synthetic_batch(api, shape, 0, DataConfig(seed=0))
        for k, v in batch.items():
            assert torch.equal(v.to_local(), shd.local_block(host[k], mesh, b_sh[k].placements))
            out[f"{{name}}/batch/{{k}}"] = v.full_tensor().numpy()
        with shd.use_rules(mesh, shd.TRAIN_RULES):
            state, metrics = make_train_step(api, ocfg)(state, batch)
        out[f"{{name}}/loss"] = metrics["loss"].numpy()
        for k, v in ckpt.host_arrays(state).items():
            out[f"{{name}}/step{{k}}"] = v
        # the reference's checkpoint onto this mesh, then the placed save
        fresh = place_state(init_state(api, torch.Generator().manual_seed(1), ocfg), st_sh)
        restored = ckpt.restore_checkpoint(f"{{tmp}}/ref_ckpt", 3, fresh, shardings=st_sh)
        for k, v in ckpt.host_arrays(restored).items():
            out[f"{{name}}/restored{{k}}"] = v
        ckpt.save_checkpoint(f"{{tmp}}/placed_{{name}}", 3, restored)
        if first is None:  # elastic re-shard: this mesh's step state onto the next mesh
            ckpt.save_checkpoint(f"{{tmp}}/elastic", 1, state)
            first = name
        else:
            target = place_state(init_state(api, torch.Generator().manual_seed(2), ocfg), st_sh)
            got = ckpt.CheckpointManager(f"{{tmp}}/elastic").restore_latest(target, shardings=st_sh)
            assert got[0] == 1
            for k, v in ckpt.host_arrays(got[1]).items():
                out[f"elastic{{k}}"] = v
    # olmoe on (1, 2): the MoE layers take the EP path (an exchange over
    # "model"); capacity factor 8, so no token is dropped
    moe_cfg = dataclasses.replace(get_config("olmoe-1b-7b", reduced=True), compute_dtype="float32",
                                  capacity_factor=8.0)
    moe_api = build(moe_cfg)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    st_sh = state_shardings(moe_api, ocfg, mesh, shd.TRAIN_RULES)
    b_sh = batch_shardings(moe_api.train_inputs(shape), mesh, shd.TRAIN_RULES)
    state = place_state(init_state(moe_api, torch.Generator().manual_seed(0), ocfg), st_sh)
    batch = next(batch_iterator(moe_api, shape, DataConfig(seed=0), shardings=b_sh))
    with shd.use_rules(mesh, shd.TRAIN_RULES):
        state, metrics = make_train_step(moe_api, ocfg)(state, batch)
    out["moe/loss"] = metrics["loss"].numpy()
    for k, v in ckpt.host_arrays(state).items():
        out[f"moe/step{{k}}"] = v
    # the launcher on the 2-rank group: --mesh local is (2, 1); a relaunch
    # after losing the last checkpoint resumes from the one before
    import shutil
    from repro_torch.launch import train
    argv = ["--arch", "{ARCH}", "--reduced", "--steps", "4", "--batch", "{B}", "--seq", "{S}", "--ckpt-dir",
            f"{{tmp}}/launch", "--ckpt-every", "2", "--device", "cpu"]
    rep1, st1 = train.main(argv)
    assert isinstance(tree_leaves(st1.params)[0], DTensor)
    if rank == 0:
        shutil.rmtree(f"{{tmp}}/launch/step_00000004")
    dist.barrier()
    rep2, st2 = train.main(argv)
    out["launch/losses"], out["launch/relaunch_losses"] = np.array(rep1.losses), np.array(rep2.losses)
    out["launch/resumed_from"] = np.array(rep2.resumed_from)
    a1, a2 = ckpt.host_arrays(st1), ckpt.host_arrays(st2)
    out["launch/bitwise"] = np.array(all(np.array_equal(a1[k], a2[k]) for k in a1))
    if rank == 0:
        np.savez(f"{{tmp}}/out.npz", **out)
    dist.barrier()  # no rank tears its group down while a peer's last exchange is in flight
    dist.destroy_process_group()
"""


def _cfg():
    return dataclasses.replace(get_config(ARCH, reduced=True), compute_dtype="float32")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement")
    r_cfg = dataclasses.replace(r_get_config(ARCH, reduced=True), compute_dtype="float32")
    r_state = r_init_state(r_build(r_cfg), jax.random.PRNGKey(3), r_opt.OptimizerConfig())
    r_save_checkpoint(str(tmp / "ref_ckpt"), 3, r_state)
    run_ranks(RANK_CODE, 2, tmp)
    return tmp, dict(np.load(tmp / "out.npz"))


def _one_process_step(cfg):
    """The unplaced step on the same initial state and batch."""
    api = build(cfg)
    ocfg = opt.OptimizerConfig(total_steps=10, warmup_steps=1)
    state = init_state(api, torch.Generator().manual_seed(0), ocfg)
    batch = next(batch_iterator(api, ShapeConfig("t", S, B, "train"), DataConfig(seed=0), device="cpu"))
    state, metrics = make_train_step(api, ocfg)(state, batch)
    return float(metrics["loss"]), host_arrays(state), ocfg


@pytest.fixture(scope="module")
def one_process():
    return _one_process_step(_cfg())


def _check_step(out, prefix, loss, arrays, ocfg):
    """Loss at 1e-5 of scale; gradients (mu / (1 - b1)) and sqrt(nu / (1 -
    b2)) at 1e-4 of the gradients' scale."""
    assert abs(float(out[f"{prefix}/loss"]) - loss) <= 1e-5 * max(1.0, abs(loss))
    grads = {k: v / (1 - ocfg.beta1) for k, v in arrays.items() if k.startswith(".opt.mu")}
    g_scale = max(1.0, max(float(np.abs(v).max()) for v in grads.values()))
    for k, want in grads.items():
        got = out[f"{prefix}/step{k}"] / (1 - ocfg.beta1)
        assert got.shape == want.shape, k
        assert float(np.abs(got - want).max()) <= 1e-4 * g_scale, (k, float(np.abs(got - want).max()))
    for k, want in arrays.items():
        if k.startswith(".opt.nu"):
            got = out[f"{prefix}/step{k}"] / (1 - ocfg.beta2)
            assert float(np.abs(np.sqrt(got) - np.sqrt(want / (1 - ocfg.beta2))).max()) <= 1e-4 * g_scale, k
    assert int(out[f"{prefix}/step.opt.count"]) == 1


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_step_matches_one_process_step(ranks, one_process, mesh):
    _check_step(ranks[1], mesh, *one_process)


def test_placed_moe_step_on_the_ep_path_matches_one_process_step(ranks):
    """olmoe on (1, 2): both ranks hold the batch, the experts split over
    "model" with an exchange each way, against the one-process capacity
    path (no drops at capacity factor 8, so the two dispatches agree)."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", reduced=True), compute_dtype="float32", capacity_factor=8.0)
    _check_step(ranks[1], "moe", *_one_process_step(cfg))


def test_launcher_on_two_ranks_resumes_bitwise(ranks):
    _, out = ranks
    losses, relaunch = out["launch/losses"], out["launch/relaunch_losses"]
    assert len(losses) == 4 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert int(out["launch/resumed_from"]) == 2
    np.testing.assert_array_equal(relaunch, losses[2:])
    assert bool(out["launch/bitwise"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_batch_is_the_reference_batch(ranks, mesh):
    _, out = ranks
    r_cfg = dataclasses.replace(r_get_config(ARCH, reduced=True), compute_dtype="float32")
    want = r_synthetic_batch(r_build(r_cfg), RShape("t", S, B, "train"), 0)
    assert sorted(want) == sorted(k.split("/")[-1] for k in out if k.startswith(f"{mesh}/batch/"))
    for k, v in want.items():
        np.testing.assert_array_equal(out[f"{mesh}/batch/{k}"], v)


def _ckpt_arrays(path: pathlib.Path) -> tuple[dict, dict]:
    with open(path / "manifest.json") as f:
        index = json.load(f)["index"]
    files = {e["file"]: dict(np.load(path / e["file"])) for e in index.values()}
    return index, {name: files[e["file"]][e["key"]] for name, e in index.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_reference_checkpoint_restores_onto_two_ranks_bitwise(ranks, mesh):
    tmp, out = ranks
    _, want = _ckpt_arrays(tmp / "ref_ckpt" / "step_00000003")
    for name, arr in want.items():
        got = out[f"{mesh}/restored{name}"]
        assert got.dtype == arr.dtype and got.shape == arr.shape, name
        np.testing.assert_array_equal(got, arr, err_msg=name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_save_writes_the_unplaced_files(ranks, mesh):
    tmp, _ = ranks
    index, arrays = _ckpt_arrays(tmp / f"placed_{mesh}" / "step_00000003")
    r_index, r_arrays = _ckpt_arrays(tmp / "ref_ckpt" / "step_00000003")
    assert index == r_index
    assert sorted(p.name for p in (tmp / f"placed_{mesh}" / "step_00000003").iterdir()) == sorted(
        p.name for p in (tmp / "ref_ckpt" / "step_00000003").iterdir())
    for name, arr in r_arrays.items():
        np.testing.assert_array_equal(arrays[name], arr, err_msg=name)


def test_elastic_reshard_roundtrip(ranks):
    _, out = ranks
    first = next(iter(MESHES))
    names = [k[len("elastic"):] for k in out if k.startswith("elastic")]
    assert names and all(f"{first}/step{n}" in out for n in names)
    for n in names:
        np.testing.assert_array_equal(out[f"elastic{n}"], out[f"{first}/step{n}"], err_msg=n)


def test_one_device_mesh_keeps_plain_tensors():
    api = build(_cfg())
    ocfg = opt.OptimizerConfig()
    state = init_state(api, torch.Generator().manual_seed(0), ocfg)
    before = tree_leaves(state)
    with mesh_lib.process_group("cpu"):
        mesh = mesh_lib.make_local_mesh("cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        sh = state_shardings(api, ocfg, mesh, shd.TRAIN_RULES)
        placed = place_state(state, sh)
    after = tree_leaves(placed)
    assert len(before) == len(after) and all(a is b for a, b in zip(before, after))
    assert not any(isinstance(x, DTensor) for x in after)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize(("mesh", "ranks_needed"), [("pod", 256), ("multipod", 512)])
def test_production_mesh_raises_on_one_process(mesh, ranks_needed):
    argv = ["--arch", ARCH, "--reduced", "--steps", "1", "--batch", "2", "--seq", "8", "--device", "cpu",
            "--mesh", mesh]
    with pytest.raises(RuntimeError, match=f"needs {ranks_needed} ranks"):
        t_train.main(argv)
    assert not torch.distributed.is_initialized()
