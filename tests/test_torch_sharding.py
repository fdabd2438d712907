"""The port's logical-axis rules (``repro_torch.distributed.sharding``)
against the reference's ``repro.distributed.sharding``.

- the eight cases of ``tests/test_sharding.py`` and the two rule cases of
  ``tests/test_perf_features.py`` (ZeRO-3, EP), mirrored;
- ``spec_for`` entry for entry equal to the reference's for every leaf of
  the train state (``state_logical``), the train and serve batch specs and
  the decode cache specs of all ten registered architectures at full size,
  under the four rule tables, on the (16, 16) and (2, 16, 16) meshes.  The
  port's per-layer leaves drop the stacked axis, so their specs are the
  reference's with its first entry (always replicated) dropped;
- placements on fake (16, 16) and (2, 16, 16) ``DeviceMesh``es (a fake
  512-rank world, ``FakeStore``) for the multi-axis specs, with each
  rank-0 block's shape;
- ``tree_shardings`` and ``abstract_with_sharding`` over a batch's specs;
- ``shard_activation``: the identity outside a rule context and on plain
  tensors, a redistribution of a ``DTensor`` inside one.

Everything runs in this process; the fake process group is destroyed at
the end of its fixture.
"""

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_config as r_get_config
from repro.configs.shapes import DECODE_32K, PREFILL_32K, TRAIN_4K
from repro.distributed import sharding as r_shd
from repro.distributed.compat import abstract_mesh as r_abstract_mesh
from repro.models import build as r_build
from repro.models.model_zoo import spec_logical as r_spec_logical
from repro.training import optimizer as r_opt
from repro.training.train_step import abstract_state as r_abstract_state
from repro.training.train_step import state_logical as r_state_logical
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, spec_for
from repro_torch.models import build
from repro_torch.models.common import layer_specs
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import state_logical

RULES = {"train": "TRAIN_RULES", "serve": "SERVE_RULES", "ep": "EP_RULES", "zero3": "ZERO3_RULES"}
MESHES = {"pod": ((16, 16), ("data", "model")), "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(multi_pod=False):
    shape, names = MESHES["multipod" if multi_pod else "pod"]
    return shd.AbstractMesh(shape, names)


def _ref(spec) -> tuple:
    return tuple(spec)


# --- tests/test_sharding.py, mirrored -------------------------------------


def test_batch_falls_back_without_pod():
    assert spec_for(("batch", None), (256, 128), _mesh(), shd.TRAIN_RULES) == P("data")


def test_batch_uses_pod_and_data_when_present():
    assert spec_for(("batch", None), (256, 128), _mesh(True), shd.TRAIN_RULES) == P(("pod", "data"))


def test_divisibility_fallback_to_replication():
    assert spec_for(("heads",), (40,), _mesh(), shd.TRAIN_RULES) == P()
    assert spec_for(("embed", "qkv"), (5120, 5120), _mesh(), shd.TRAIN_RULES) == P("data", "model")


def test_axis_reuse_forbidden():
    assert spec_for(("qkv", "mlp"), (512, 512), _mesh(), shd.TRAIN_RULES) == P("model")


def test_kv_cache_priority():
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    assert spec_for(axes, (40, 128, 32768, 8, 128), _mesh(), shd.SERVE_RULES) == P(None, "data", "model")
    assert spec_for(axes, (40, 128, 32768, 32, 128), _mesh(), shd.SERVE_RULES) == P(None, "data", None, "model")


def test_vocab_on_model():
    assert spec_for(("vocab", "embed"), (49664, 4096), _mesh(), shd.TRAIN_RULES) == P("model", "data")


def test_unknown_logical_axis_replicates():
    assert spec_for(("nonexistent",), (64,), _mesh(), shd.TRAIN_RULES) == P()


def test_serve_rules_replicate_weights_over_data():
    assert spec_for(("embed", "qkv"), (4096, 4096), _mesh(), shd.SERVE_RULES) == P(None, "model")


# --- tests/test_perf_features.py's rule cases, mirrored -------------------


def test_zero3_batch_takes_both_axes():
    m = _mesh()
    assert spec_for(("batch", None), (256, 128), m, shd.ZERO3_RULES) == P(("data", "model"))
    assert spec_for(("embed", "qkv"), (4096, 4096), m, shd.ZERO3_RULES) == P(("data", "model"))
    assert spec_for(("vocab", "embed"), (50176, 4096), m, shd.ZERO3_RULES) == P(None, ("data", "model"))
    assert spec_for(("embed", "lm_head"), (4096, 50176), m, shd.ZERO3_RULES) == P(None, ("data", "model"))


def test_ep_rules_reserve_model_for_experts():
    m = _mesh()
    assert spec_for(("expert", "embed", "expert_mlp"), (64, 2048, 1408), m, shd.EP_RULES) == P("model", "data")
    assert spec_for(("embed", "qkv"), (2048, 2048), m, shd.EP_RULES) == P("data")


def test_rule_tables_are_the_references():
    for name in RULES.values():
        assert getattr(shd, name) == getattr(r_shd, name), name
    assert shd._PRIORITY == r_shd._PRIORITY


# --- every leaf of all ten architectures ----------------------------------

_STACKED = ("['layers']", "['pairs']", "['enc_layers']", "['dec_layers']")


def _port_specs(tree, shapes, mesh, rules, path=""):
    """{reference keystr path: spec} over the port's state layout; a per-layer
    list gives one entry per leaf path (every layer must agree)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_port_specs(getattr(tree, f), getattr(shapes, f), mesh, rules, f"{path}.{f}"))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_specs(tree[k], shapes[k], mesh, rules, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, list):
        layers = [_port_specs(t, s, mesh, rules, path) for t, s in zip(tree, shapes)]
        assert all(lay == layers[0] for lay in layers), path
        return {k: ("stacked", v) for k, v in layers[0].items()}
    if tree is None:
        return {}
    return {path: spec_for(tree, shapes.shape if hasattr(shapes, "shape") else (), mesh, rules)}


def _ref_specs(logical, abstract, mesh, rules):
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)  # noqa: E731
    flat_l = jax.tree_util.tree_flatten_with_path(logical, is_leaf=is_axes)[0]
    flat_a = jax.tree.leaves(abstract)
    assert len(flat_l) == len(flat_a)
    return {jax.tree_util.keystr(kp): r_shd.spec_for(ax, a.shape, mesh, rules) for (kp, ax), a in zip(flat_l, flat_a)}


class _Shapes:
    """A leaf with a ``.shape`` (the 0-dim ``count``)."""
    shape = ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_state_and_batch_specs_match_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh, r_mesh = shd.AbstractMesh(shape, names), r_abstract_mesh(shape, names)
    api, r_api = build(get_config(arch)), r_build(r_get_config(arch))
    cfg = opt.OptimizerConfig(compress_grads=True)
    r_cfg = r_opt.OptimizerConfig(compress_grads=True)
    log = state_logical(api, cfg)
    specs = layer_specs(api.params_def)
    shaped = log._replace(params=specs, opt=log.opt._replace(mu=specs, nu=specs, count=_Shapes(), err=specs))
    checked = 0
    for table in RULES.values():
        rules, r_rules = getattr(shd, table), getattr(r_shd, table)
        got = _port_specs(log, shaped, mesh, rules)
        want = _ref_specs(r_state_logical(r_api, r_cfg), r_abstract_state(r_api, r_cfg), r_mesh, r_rules)
        assert set(got) == set(want), (set(got) ^ set(want))
        for path, spec in got.items():
            ref = _ref(want[path])
            if isinstance(spec, tuple) and spec[:1] == ("stacked",):
                assert any(s in path for s in _STACKED), path
                assert ref[:1] in ((), (None,)), (path, ref)
                assert tuple(spec[1]) == ref[1:], (table, path, spec[1], ref)
            else:
                assert tuple(spec) == ref, (table, path, spec, ref)
            checked += 1
        # batch specs (train, prefill) and the decode cache
        for s in (TRAIN_4K, PREFILL_32K, DECODE_32K):
            pairs = [(api.train_inputs(s), r_spec_logical(r_api.train_inputs(s)), r_api.train_inputs(s)),
                     (api.prefill_inputs(s), r_spec_logical(r_api.prefill_inputs(s)), r_api.prefill_inputs(s)),
                     (api.cache_spec(s), r_spec_logical(r_api.cache_spec(s)), r_api.cache_spec(s))]
            for port_tree, r_axes, r_tree in pairs:
                assert sorted(port_tree) == sorted(r_tree)
                for k, t in port_tree.items():
                    assert t.axes == r_axes[k] and tuple(t.shape) == tuple(r_tree[k].shape), (k, t)
                    assert tuple(spec_for(t.axes, t.shape, mesh, rules)) == _ref(
                        r_shd.spec_for(r_axes[k], r_tree[k].shape, r_mesh, r_rules)), (table, s.name, k)
                    checked += 1
    assert checked > 100


# --- placements on a fake 256-rank mesh -----------------------------------


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_multi_axis_placements_on_fake_meshes(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    pod = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    multipod = init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
    cases = [
        (pod, ("batch", None), (256, 128), shd.ZERO3_RULES, (Shard(0), Shard(0))),
        (pod, ("vocab", "embed"), (50176, 4096), shd.ZERO3_RULES, (Shard(1), Shard(1))),
        (pod, ("embed", "qkv"), (4096, 4096), shd.TRAIN_RULES, (Shard(0), Shard(1))),
        (pod, ("expert", "embed", "expert_mlp"), (64, 2048, 1408), shd.TRAIN_RULES, (Shard(1), Shard(0))),
        (multipod, ("batch", None), (256, 128), shd.TRAIN_RULES, (Shard(0), Shard(0), Replicate())),
        (multipod, ("batch", "seq", "act_embed"), (512, 8, 64), shd.ZERO3_RULES, (Shard(0), Shard(0), Shard(0))),
    ]
    for mesh, axes, shape, rules, want in cases:
        sh = shd.sharding_for(axes, shape, mesh, rules)
        assert sh.placements == want, (axes, sh)
        r_mesh = r_abstract_mesh(tuple(mesh.shape), mesh.mesh_dim_names)
        r_spec = r_shd.spec_for(axes, shape, r_mesh, {k: v for k, v in getattr(r_shd, _table(rules)).items()})
        assert tuple(sh.spec) == tuple(r_spec)
        # rank 0's block: each sharded dim cut by the product of its axes
        block = shd.local_block(torch.zeros(shape), mesh, sh.placements)
        want_shape = list(shape)
        for entry_dim, entry in enumerate(sh.spec):
            axes_ = (entry,) if isinstance(entry, str) else tuple(entry or ())
            for a in axes_:
                want_shape[entry_dim] //= dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
        assert list(block.shape) == want_shape, (axes, block.shape, want_shape)
    with pytest.raises(AssertionError):  # axes out of mesh order
        shd.placements_for(P(("data", "pod")), multipod)


def _table(rules) -> str:
    return next(name for name in RULES.values() if getattr(shd, name) is rules)


def test_shard_activation(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.randn(32, 8, 4)
    assert shd.shard_activation(x, ("batch", "seq", "act_embed")) is x  # no context
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    with shd.use_rules(mesh, shd.TRAIN_RULES):
        assert shd.shard_activation(x, ("batch", "seq", "act_embed")) is x  # a plain tensor
        d = DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
        y = shd.shard_activation(d, ("batch", "seq", "act_embed"))
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert torch.equal(y.to_local(), x.chunk(16)[0])
    assert shd._active() is None


def test_tree_shardings_and_abstract_with_sharding():
    """The tree helpers over a batch's ``TensorSpec`` tree: each leaf's
    sharding is ``sharding_for`` of its own axes and shape."""
    api = build(get_config("olmoe-1b-7b"))
    specs = api.train_inputs(TRAIN_4K)
    logical = {k: s.axes for k, s in specs.items()}
    mesh = _mesh(True)
    trees = shd.tree_shardings(logical, specs, mesh, shd.TRAIN_RULES)
    placed = shd.abstract_with_sharding(specs, logical, mesh, shd.TRAIN_RULES)
    for k, s in specs.items():
        want = shd.sharding_for(s.axes, s.shape, mesh, shd.TRAIN_RULES)
        assert trees[k] == want and placed[k].sharding == want
        assert (placed[k].shape, placed[k].dtype, placed[k].axes) == (s.shape, s.dtype, s.axes)
    assert trees["tokens"].spec == P(("pod", "data"))
