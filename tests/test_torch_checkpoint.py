"""The port's checkpoints (``distributed/checkpoint.py``), on the CPU.

The seven cases of ``tests/test_checkpoint.py`` mirrored (atomic commit,
damaged-tail fallback, in-flight directories ignored, retention, async
save, shape mismatch, and the re-layout path: the reference's re-shard
onto a mesh becomes the port's per-layer tensors restored from the
reference's stacked leaves), then the two packages' shared layout: a
checkpoint the reference writes of a reduced internlm2 ``TrainState``
restores into the port bit for bit equal to
``convert.train_state_from_numpy`` of the same arrays, and one the port
writes restores into the reference.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.distributed import checkpoint as r_ckpt
from repro.models import build as r_build
from repro.training import optimizer as r_opt
from repro.training.train_step import init_state as r_init_state
from repro_torch.configs.registry import get_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.distributed.checkpoint import (
    CheckpointManager,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.models import build
from repro_torch.models.common import leaf_groups, tree_leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import init_state


def _state(rng):
    return {
        "params": {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
                   "b": torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))},
        "count": torch.tensor(3, dtype=torch.int32),
        "maybe": None,
    }


def _zeros_like(state):
    return {"params": {k: torch.zeros_like(v) for k, v in state["params"].items()},
            "count": torch.zeros((), dtype=torch.int32), "maybe": None}


def test_save_restore_roundtrip(rng, tmp_path):
    state = _state(rng)
    save_checkpoint(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    target = _zeros_like(state)
    got = restore_checkpoint(str(tmp_path), 7, target)
    assert got is target and torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["maybe"] is None and int(got["count"]) == 3


def test_damaged_tail_falls_back(rng, tmp_path):
    state = _state(rng)
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, state, blocking=True)
    first = state["params"]["w"].clone()
    state["params"]["w"] += 1.0
    mgr.save(2, state, blocking=True)
    with open(tmp_path / "step_00000002" / "manifest.json", "w") as f:
        f.write("{ not json")  # a crash mid-save
    step, got = mgr.restore_latest(_zeros_like(state))
    assert step == 1 and torch.equal(got["params"]["w"], first)


def test_incomplete_manifest_ignored(rng, tmp_path):
    save_checkpoint(str(tmp_path), 4, _state(rng))
    os.makedirs(tmp_path / ".tmp-ckpt-xyz")  # an in-flight save is invisible
    assert list_steps(str(tmp_path)) == [4]


def test_retention_gc(rng, tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(rng), blocking=True)
    assert list_steps(str(tmp_path)) == [3, 4]


def test_async_save(rng, tmp_path):
    """The snapshot is taken at ``save``: changing the state while the
    write runs does not reach the checkpoint."""
    state = _state(rng)
    want = state["params"]["w"].clone()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(9, state, blocking=False)
    state["params"]["w"].zero_()
    mgr.wait()
    assert latest_step(str(tmp_path)) == 9
    assert torch.equal(restore_checkpoint(str(tmp_path), 9, _zeros_like(state))["params"]["w"], want)


def test_shape_mismatch_rejected_and_target_untouched(rng, tmp_path):
    """A wrong shape raises before any leaf is written, as a missing leaf
    does, so a failed restore leaves the target as it was."""
    state = _state(rng)
    save_checkpoint(str(tmp_path), 1, state)
    bad = {"params": {"w": torch.full((4, 4), 7.0), "b": torch.full((8,), 7.0)}, "count": torch.tensor(0)}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, bad)
    assert torch.equal(bad["params"]["b"], torch.full((8,), 7.0))
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), 1, {"other": torch.zeros(2)})


def test_per_layer_relayout_roundtrip(rng, tmp_path):
    """The re-layout path (the reference's elastic re-shard restores onto
    any mesh): per-layer tensors are saved as one stacked (L, ...) leaf
    under the reference's path and restored into per-layer tensors."""
    layers = [{"k": torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32))} for _ in range(4)]
    state = {"params": {"layers": layers, "b": torch.ones(2)}}
    save_checkpoint(str(tmp_path), 2, state)
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["index"]["['params']['layers']['k']"]["shape"] == [4, 3, 2]
    target = {"params": {"layers": [{"k": torch.zeros(3, 2)} for _ in range(4)], "b": torch.zeros(2)}}
    got = restore_checkpoint(str(tmp_path), 2, target)
    assert all(torch.equal(a["k"], b["k"]) for a, b in zip(got["params"]["layers"], layers))


def _reference_state():
    cfg = r_get_config("internlm2-1.8b", reduced=True)
    rcfg = r_opt.OptimizerConfig(total_steps=10, warmup_steps=1)
    state = r_init_state(r_build(cfg), jax.random.PRNGKey(3), rcfg)
    rng = np.random.default_rng(4)
    noise = lambda tree: jax.tree.map(lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32), tree)
    return state._replace(opt=state.opt._replace(mu=noise(state.opt.mu), nu=noise(state.opt.nu),
                                                 count=np.asarray(5, np.int32)))


def test_reference_checkpoint_restores_bitwise(tmp_path):
    """A reduced internlm2 TrainState written by the reference restores
    into a fresh port state equal, leaf for leaf and bit for bit, to
    ``convert.train_state_from_numpy`` of the same arrays."""
    r_state = _reference_state()
    r_ckpt.save_checkpoint(str(tmp_path), 5, r_state)
    np_state = jax.tree.map(np.asarray, r_state)
    want = train_state_from_numpy(np_state.params, np_state.opt.mu, np_state.opt.nu, np_state.opt.count,
                                  cfg=get_config("internlm2-1.8b", reduced=True), device="cpu")
    api = build(get_config("internlm2-1.8b", reduced=True))
    target = init_state(api, torch.Generator().manual_seed(0), opt.OptimizerConfig(total_steps=10, warmup_steps=1))
    got = restore_checkpoint(str(tmp_path), 5, target)
    assert [n for n, _, _ in leaf_groups(got)] == [n for n, _, _ in leaf_groups(want)]
    assert len(tree_leaves(got)) == len(tree_leaves(want)) > 10
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert int(got.opt.count) == 5 and got.opt.count.dtype == torch.int32


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    r_state = _reference_state()
    np_state = jax.tree.map(np.asarray, r_state)
    state = train_state_from_numpy(np_state.params, np_state.opt.mu, np_state.opt.nu, np_state.opt.count,
                                   cfg=get_config("internlm2-1.8b", reduced=True), device="cpu")
    save_checkpoint(str(tmp_path), 6, state)
    got = r_ckpt.restore_checkpoint(str(tmp_path), 6, r_state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(r_state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
