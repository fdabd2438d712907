"""Sharding: logical-axis rules for the model zoo and the train state, and
the fleet's node axis over a list of devices -- the twin of the reference's
``repro/distributed/sharding.py``, both halves.

**Logical-axis rules.**  Parameters, batches, caches and activations are
annotated with logical axes ("embed", "qkv", "batch", "kv_heads", ...);
the rule tables ``TRAIN_RULES``, ``SERVE_RULES``, ``EP_RULES`` and
``ZERO3_RULES`` (the reference's, as data) map each onto candidate tuples
of mesh axes.  ``spec_for`` resolves one tensor's axes, in the logical
priority order ``_PRIORITY``, taking a candidate only when

  1. the dimension is divisible by the product of its mesh-axis sizes, and
  2. none of those mesh axes is already used by another dimension,

and otherwise falls back along the chain to replication.  It returns the
port's ``PartitionSpec`` (a tuple of ``None``, an axis name or a tuple of
names, trailing ``None``s trimmed), equal entry for entry to the
reference's.  ``spec_for`` reads only the mesh's axis sizes, so it takes a
``torch.distributed.DeviceMesh`` with named dimensions or an
``AbstractMesh`` (axis sizes alone, for rule checks at production sizes).

``sharding_for`` turns a spec into DTensor placements, one per mesh
dimension (``Shard(i)`` where tensor dim ``i`` names that mesh axis,
``Replicate()`` elsewhere), kept in a ``NamedSharding`` record (mesh,
spec, placements).  A tensor dim on two mesh axes becomes two ``Shard(i)``:
DTensor splits them in mesh-dimension order, which is JAX's major-to-minor
order only because every rule tuple lists its axes in mesh order, and
``sharding_for`` asserts that.

``use_rules(mesh, rules)`` activates a (mesh, rules) pair on a
``threading.local``; inside it ``shard_activation`` redistributes a
``DTensor`` activation to its resolved placements, and outside it (or for
a plain tensor) it is the identity, so model code stays mesh-agnostic.
The port's placed train step (``training.train_step``) and the dry run's
serve programs run the model on each rank's local tensors
(``local_view``), so there the calls are identities; the rule context
selects the MoE block's expert-parallel path and gives the "model" group
to the tensor-parallel products (``distributed.tensor_parallel``), which
run on the "model" blocks that ``local_view(split=...)`` keeps.

**Fleet-axis sharding** (``FleetMesh``).  The reference shards the
engines' B-node axis with ``shard_map`` over a 1-D JAX ``Mesh``; here a
sharded tree is a ``Shards`` tuple holding one tree per mesh device, each
with that device's contiguous block of B / n nodes on its leading axis,
and the engines run their unsharded local function on each shard in turn
from one host thread (``core.engine.sharding``).  CUDA launches return
before the work is done, so shards on separate cards overlap.  Per-node
math needs no communication; the one cross-shard reduction is
``fleet_attribution_totals`` (the reference's ``psum``).

Two departures from the reference, both recorded in ROADMAP Queue 3:

- a mesh may repeat a device (``fleet_mesh(devices=["cpu"] * 4)``): JAX's
  ``Mesh`` refuses that, but it is how the split, join and totals logic runs
  on a machine with one device.  It measures no scaling;
- host scalars (the stream's ``tick_in_step`` / ``step_idx`` counters, a
  tick's ``step_completed``) are plain Python values, copied into every
  shard as the reference replicates its rank-0 leaves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Logical-axis rules
# ---------------------------------------------------------------------------

# Each rule: logical axis -> tuple of candidate mesh-axis tuples, tried in
# order; () means replicate.
Rules = dict[str, tuple[tuple[str, ...], ...]]

TRAIN_RULES: Rules = {
    "batch": (("pod", "data"), ("data",), ()),
    "seq": ((),),
    "embed": (("data",), ()),          # FSDP shard of weight rows
    "act_embed": ((),),                # activations keep embed replicated
    "qkv": (("model",), ()),           # flattened heads*head_dim
    "heads": (("model",), ()),
    "kv_heads": (("model",), ()),
    "o_in": (("model",), ()),
    "mlp": (("model",), ()),
    "vocab": (("model",), ()),
    "lm_head": (("model",), ()),      # unembed output dim (logits vocab)
    "expert": (("model",), ()),
    "expert_mlp": ((),),
    "kv_seq": (("model",), ()),        # decode KV-cache sequence fallback
    "layers": ((),),
    "state": ((),),
    "conv": ((),),
    "cap": (("pod", "data"), ("data",), ()),  # MoE capacity slots
    "frontend": ((),),
}

SERVE_RULES: Rules = {
    **TRAIN_RULES,
    "batch": (("pod", "data"), ("data",), ()),
    "embed": ((),),                    # weights replicated over data for serve
    "kv_heads": (("model",), ()),
}

#: Expert-parallel-first variant: the "model" axis is reserved for experts;
#: attention and shared-MLP weights drop TP, FSDP over "data" stays.
EP_RULES: Rules = {
    **TRAIN_RULES,
    "qkv": ((),),
    "heads": ((),),
    "kv_heads": ((),),
    "o_in": ((),),
    "mlp": ((),),
}

#: ZeRO-3 / pure-FSDP variant: the "model" axis joins the batch axis (TP
#: degree 1) and weights shard their row dim over (data x model).  The
#: embedding table keeps vocab replicated with its embed dim sharded; the
#: unembedding stays vocab-sharded.  Not for MoE: EP needs "model".
ZERO3_RULES: Rules = {
    **TRAIN_RULES,
    "batch": (("pod", "data", "model"), ("data", "model"), ("data",), ()),
    "embed": (("data", "model"), ("data",), ()),
    "qkv": ((),),
    "heads": ((),),
    "kv_heads": ((),),
    "o_in": ((),),
    "mlp": ((),),
    "vocab": ((),),
    "lm_head": (("data", "model"), ("model",), ()),
    "expert": ((),),
    "kv_seq": ((),),
}

#: When two dims of one tensor compete for the same mesh axis, the higher-
#: priority logical axis wins (a KV cache prefers kv_heads on "model",
#: falling back to kv_seq only when the head count is not divisible).
_PRIORITY = (
    "batch", "vocab", "lm_head", "expert", "qkv", "mlp", "kv_heads", "heads",
    "o_in", "embed", "kv_seq", "cap", "seq",
)
_PRIO = {name: i for i, name in enumerate(_PRIORITY)}


class PartitionSpec(tuple):
    """Per tensor dimension: ``None`` (replicated), one mesh-axis name, or a
    tuple of names (major to minor), trailing ``None``s trimmed -- the twin
    of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices (``jax.sharding.AbstractMesh``):
    enough for ``spec_for`` and for placements, not for placing data."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` with named dims, an
    ``AbstractMesh``, or anything whose ``.shape`` is such a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape.values() if isinstance(mesh.shape, dict) else mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved placement on a mesh: the spec and its DTensor placements
    (one per mesh dimension) -- the twin of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple

    @property
    def num_devices(self) -> int:
        return math.prod(mesh_axes(self.mesh).values())


_ctx = threading.local()


def _active() -> tuple[Any, Rules] | None:
    return getattr(_ctx, "active", None)


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    """Activate (mesh, rules) on this thread, so model-internal
    ``shard_activation`` calls resolve against them and ``moe_apply`` takes
    its expert-parallel path; no-op outside the context."""
    prev = _active()
    _ctx.active = (mesh, rules)
    try:
        yield
    finally:
        _ctx.active = prev


def spec_for(logical: Sequence[str | None], shape: Sequence[int], mesh, rules: Rules) -> PartitionSpec:
    """Resolve logical axes to a ``PartitionSpec`` under the divisibility
    and axis-reuse constraints, visiting dims in logical-axis priority
    order."""
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    entries: list[Any] = [None] * len(logical)
    order = sorted(
        range(len(logical)),
        key=lambda i: _PRIO.get(logical[i], len(_PRIORITY)) if logical[i] else 1e9,
    )
    for i in order:
        name, dim = logical[i], shape[i]
        if name is None:
            continue
        for cand in rules.get(name, ((),)):
            if not cand:
                break
            if any(a in used for a in cand) or any(a not in sizes for a in cand):
                continue
            if dim % math.prod(sizes[a] for a in cand) != 0:
                continue
            entries[i] = cand if len(cand) > 1 else cand[0]
            used.update(cand)
            break
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(i)`` where tensor dim ``i`` names that axis, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    owner: dict[str, int] = {}
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        # DTensor splits a dim sharded on several mesh dims in mesh order;
        # that is JAX's major-to-minor order only when the axes come in it.
        assert [names.index(a) for a in axes] == sorted(names.index(a) for a in axes), (spec, names)
        owner.update({a: i for a in axes})
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in names)


def sharding_for(logical: Sequence[str | None], shape: Sequence[int], mesh, rules: Rules) -> NamedSharding:
    """``spec_for`` resolved into a ``NamedSharding`` on ``mesh``."""
    spec = spec_for(logical, shape, mesh, rules)
    return NamedSharding(mesh, spec, placements_for(spec, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(isinstance(e, (str, type(None))) for e in x)


def map_logical(fn, logical_tree, *rest):
    """``fn(axes, *leaves)`` over a tree whose leaves are logical-axis
    tuples (nested dicts, lists and NamedTuples; ``None`` passes through),
    with matching trees ``rest``."""
    if logical_tree is None:
        return None
    if _is_axes(logical_tree):
        return fn(logical_tree, *rest)
    if hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*(map_logical(fn, x, *(r[i] for r in rest)) for i, x in enumerate(logical_tree)))
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(r[k] for r in rest)) for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(map_logical(fn, x, *(r[i] for r in rest)) for i, x in enumerate(logical_tree))
    raise TypeError(f"not a logical-axis tree: {type(logical_tree).__name__}")


def tree_shardings(logical_tree: Any, abstract_tree: Any, mesh, rules: Rules) -> Any:
    """A tree of logical-axis tuples and a matching tree of shaped leaves
    (anything with ``.shape``) -> a tree of ``NamedSharding``."""
    return map_logical(lambda axes, a: sharding_for(axes, a.shape, mesh, rules), logical_tree, abstract_tree)


def abstract_with_sharding(abstract_tree: Any, logical_tree: Any, mesh, rules: Rules) -> Any:
    """Attach shardings to a ``TensorSpec`` tree: each spec comes back with
    its ``sharding`` set -- the dry run's input specs (``launch.dryrun``),
    which ``empty_placed`` turns into this rank's blocks."""
    return map_logical(lambda axes, a: dataclasses.replace(a, sharding=sharding_for(axes, a.shape, mesh, rules)),
                       logical_tree, abstract_tree)


def empty_placed(spec_tree: Any) -> Any:
    """This rank's uninitialised blocks of a ``TensorSpec`` tree whose specs
    carry shardings (``abstract_with_sharding``), placed by ``place`` --
    the rules that place real tensors: a ``DTensor`` per leaf, or a plain
    tensor on a one-device mesh.  Under ``FakeTensorMode`` every tensor is
    fake, so the whole tensors cost nothing; each block owns its storage
    (a clone of its chunk), so its bytes are its own."""

    from torch.distributed.tensor import DTensor

    def one(spec):
        x = place(torch.empty(spec.shape, dtype=spec.dtype, device=mesh_device(spec.sharding.mesh)), spec.sharding)
        if isinstance(x, DTensor):
            x = DTensor.from_local(x.to_local().clone(), x.device_mesh, x.placements, run_check=False)
        return x

    return _map_specs(one, spec_tree)


def _map_specs(fn, tree):
    """``fn`` over every ``TensorSpec`` leaf (anything with ``.sharding``)
    of nested dicts, lists and NamedTuples; ``None`` passes through."""
    if tree is None:
        return None
    if hasattr(tree, "sharding"):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, x) for x in tree)
    raise TypeError(f"not a TensorSpec tree: {type(tree).__name__}")


#: Mesh axes that split the tokens (the batch); "model" splits the weights.
TOKEN_AXES = ("pod", "data")


def local_view(tree: Any, logical_tree: Any, mesh, *, ep: bool = False, split: Any = None) -> Any:
    """Each placed leaf as this rank's local tensor, gathered where it is
    read: whole on every mesh axis, except a "batch" dim sharded over a
    token axis, which stays this rank's block (a decode cache's sequences).
    The gradient of a gathered leaf comes back as a partial sum over the
    token axes (FSDP's pattern: reduced and scattered onto its placement).
    With ``ep`` the expert weights (leading logical axis "expert") stay as
    they are: the MoE block's expert-parallel path gathers them itself.

    ``split`` (a tree of ints matching ``tree``, ``models.common.
    split_mask``) marks the leaves that tensor-parallel consumers read
    (``distributed.tensor_parallel``).  A leaf marked 1 keeps its "model"
    block where the rules shard one of its dims over "model" alone, and is
    gathered on the token axes only; the kept block's gradient is local to
    the rank and needs no reduction over "model".  A fused leaf marked
    ``g`` > 1, whose dim on "model" is ``g`` equal groups (Mamba2's ``[z |
    xin]``), is gathered whole over "model" as well and read as this rank's
    block of each group, joined (``[z_r | xin_r]``): the columns of the
    rank's own heads or channels.  Each rank reads a different part of it,
    so its gradient comes back as a partial sum over "model" too, reduced
    and scattered onto its placement.  Where a group does not divide by the
    "model" size the leaf is read whole.  Plain leaves (0) come back as
    they are.  The placed train step reads its parameters through it; the
    dry run's serve programs their parameters and caches."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = mesh.mesh_dim_names

    def gather(leaf, axes, groups=0):
        if not isinstance(leaf, DTensor) or (ep and axes[:1] == ("expert",)):
            return leaf
        token_dims = {p.dim for n, p in zip(names, leaf.placements) if n in TOKEN_AXES and isinstance(p, Shard)}
        model_dim = next((p.dim for n, p in zip(names, leaf.placements)
                          if n == "model" and isinstance(p, Shard) and p.dim not in token_dims), None)
        size = mesh.size(names.index("model")) if model_dim is not None else 1
        regroup = groups > 1 and model_dim is not None and (leaf.shape[model_dim] // groups) % size == 0

        def kept(n, p):
            if not isinstance(p, Shard):
                return False
            if n in TOKEN_AXES:
                return axes[p.dim] == "batch"
            return groups == 1 and n == "model" and p.dim == model_dim

        keep = [p if kept(n, p) else Replicate() for n, p in zip(names, leaf.placements)]
        grad = [Partial() if isinstance(p, Replicate) and (n in TOKEN_AXES or (regroup and n == "model")) else p
                for n, p in zip(names, keep)]
        local = leaf.redistribute(mesh, keep).to_local(grad_placements=grad)
        if not regroup:
            return local
        rank = mesh.get_local_rank("model")
        blocks = local.unflatten(model_dim, (groups, size, -1)).select(model_dim + 1, rank)
        return blocks.flatten(model_dim, model_dim + 1).contiguous()

    from repro_torch.models.common import map_tree

    if split is None:
        return map_tree(gather, tree, logical_tree)
    return map_tree(gather, tree, logical_tree, split)


def shard_activation(x, logical: Sequence[str | None]):
    """Constrain an activation's placement if a rule context is active: a
    ``DTensor`` is redistributed to the resolved placements; a plain
    tensor (a rank's local block, or any tensor outside a context) comes
    back as it is."""
    active = _active()
    if active is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = active
    return x.redistribute(x.device_mesh, sharding_for(logical, x.shape, mesh, rules).placements)


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``placements`` on
    ``mesh``: for each mesh dim in order, its ``Shard(i)`` cuts dim ``i``
    into equal chunks and keeps this rank's coordinate (DTensor's layout;
    ``spec_for`` shards only divisible dims).  No communication."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for mesh_dim, placement in enumerate(placements):
        if isinstance(placement, Shard):
            x = x.chunk(mesh.size(mesh_dim), dim=placement.dim)[coord[mesh_dim]]
    return x


def place(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the whole tensor, equal on every rank) placed by ``sharding``:
    on a mesh of one device the whole tensor on that device; otherwise a
    ``DTensor`` built from this rank's block, with no communication.  The
    block owns its storage: a view into ``x`` (a block of rows, or a
    per-layer leaf of a stacked tensor) would keep all of ``x`` alive."""
    from torch.distributed.tensor import DTensor

    dev = mesh_device(sharding.mesh)
    if isinstance(x, DTensor):
        if x.device_mesh == sharding.mesh and tuple(x.placements) == tuple(sharding.placements):
            return x
        x = x.full_tensor()
    if sharding.num_devices == 1:
        return x.to(dev)
    block = local_block(x, sharding.mesh, sharding.placements).to(dev)
    if not block.is_contiguous() or block.untyped_storage().nbytes() != block.numel() * block.element_size():
        block = block.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(block, sharding.mesh, sharding.placements, run_check=False)


def place_tree(tree: Any, shardings: Any) -> Any:
    """``place`` over matching trees of tensors and ``NamedSharding``s
    (NamedTuples, dicts and lists are rebuilt; an ``nn.Module`` tree -- a
    ``ParamTree`` -- has its parameters replaced in place, gradient flags
    kept).  A ``None`` sharding leaves its leaf as it is, and a leaf already
    where its sharding puts it comes back as the same object."""
    if shardings is None or tree is None:
        return tree
    if isinstance(shardings, NamedSharding):
        return place(tree, shardings)
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for name, param in list(tree._parameters.items()):
                placed = place(param, shardings[name])
                if placed is not param:
                    tree._parameters[name] = torch.nn.Parameter(placed, requires_grad=param.requires_grad)
        for name, mod in tree._modules.items():
            place_tree(mod, shardings[int(name)] if isinstance(shardings, list) else shardings[name])
        return tree
    if hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(x, sh) for x, sh in zip(tree, shardings)))
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(x, sh) for x, sh in zip(tree, shardings))
    return tree


# ---------------------------------------------------------------------------
# Fleet-axis sharding: the B-node axis of the engines over a list of devices
# ---------------------------------------------------------------------------

#: Name of the fleet's node axis.
FLEET_AXIS = "node"


class Shards(tuple):
    """One tree per device of a ``FleetMesh``, in mesh order: shard ``i``
    holds the i-th contiguous block of the node axis, on device ``i``."""


def _is_leaf_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor (or numpy array) leaf of a tree of
    NamedTuples, tuples and lists; ``None`` and host scalars pass through
    unchanged."""
    if _is_leaf_array(tree):
        return fn(torch.as_tensor(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def _join(parts: list, device: torch.device):
    """Concatenate matching trees along their leading axis onto ``device``
    (one part is returned as it is); host scalars are taken from the first
    part, where every shard holds the same value."""
    first = parts[0]
    if len(parts) == 1:
        return first
    if isinstance(first, torch.Tensor):
        if first.ndim == 0:
            return first.to(device)
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_join([p[i] for p in parts], device) for i in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(_join([p[i] for p in parts], device) for i in range(len(first)))
    return first


def _first_device(tree) -> torch.device | None:
    found: list[torch.device] = []
    _tree_map(lambda t: found.append(t.device) or t, tree)
    return found[0] if found else None


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D device mesh over the fleet's node (B) axis.

    Frozen and hashable, like the reference's.  The node axis is the
    outermost dimension of every fleet tensor (``FleetInputs``,
    ``FleetStreamState`` buffers, ``FleetResult`` leaves); device ``i`` of
    the ``num_devices`` owns the i-th contiguous block of ``B / num_devices``
    nodes.  A device may appear more than once.
    """

    devices: tuple
    axis: str = FLEET_AXIS

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a FleetMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def num_devices(self) -> int:
        """Devices along the node axis."""
        return len(self.devices)

    def validate(self, num_nodes: int) -> None:
        """Reject fleets whose node count does not tile the mesh evenly."""
        if num_nodes % self.num_devices != 0:
            raise ValueError(
                f"fleet of {num_nodes} node(s) is not divisible by the "
                f"{self.num_devices}-device '{self.axis}' mesh; pad the fleet "
                f"or build the mesh with fleet_mesh(num_nodes={num_nodes})"
            )

    def split(self, tree) -> list:
        """``tree`` cut into one tree per device: every tensor leaf of rank
        >= 1 is cut into contiguous blocks along its leading axis (which
        must tile the mesh), each moved to its device; rank-0 tensors are
        copied to every device, and ``None`` and host scalars pass through.
        A block on the device it already lies on is a view, not a copy."""
        n = self.num_devices

        def block(i):
            dev = self.devices[i]

            def cut(t):
                if t.ndim == 0:
                    return t.to(dev)
                self.validate(t.shape[0])
                size = t.shape[0] // n
                return (t if n == 1 else t[i * size : (i + 1) * size]).to(dev)

            return _tree_map(cut, tree)

        return [block(i) for i in range(n)]

    def join(self, parts: Sequence) -> Any:
        """The per-device trees ``parts`` concatenated along the node axis
        on the mesh's first device (a one-device mesh returns its one part
        as it is, with no copy)."""
        return _join(list(parts), self.devices[0])

    def put(self, tree: Any) -> Shards:
        """Place a tree on the mesh: a ``Shards`` of ``split(tree)``
        (``join`` is its inverse)."""
        return Shards(self.split(tree))

    def specs_like(self, tree: Any) -> Any:
        """Per-leaf placement, the torch equivalent of the reference's
        ``PartitionSpec`` tree: ``axis`` for a leaf split over the nodes,
        ``None`` for one copied to every device (rank-0 tensors, host
        scalars)."""
        if _is_leaf_array(tree):
            return self.axis if np.ndim(tree) > 0 else None
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(self.specs_like(x) for x in tree))
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.specs_like(x) for x in tree)
        return None


def _visible_cuda() -> list[str]:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def fleet_mesh(
    num_nodes: int | None = None,
    *,
    devices: Sequence[Any] | None = None,
    axis: str = FLEET_AXIS,
) -> FleetMesh:
    """Build a ``FleetMesh`` over ``devices`` (default: every visible CUDA
    device; raises when there is none).

    With ``num_nodes`` the mesh uses the *largest* leading run of the
    devices whose length divides the fleet, so an awkward fleet size gets
    fewer devices instead of failing.  The one-device mesh is the identity
    sharding: every ``mesh=`` path gives the mesh=None result bit for bit.
    """
    devs = list(_visible_cuda() if devices is None else devices)
    if not devs:
        raise RuntimeError("fleet_mesh: no CUDA device is visible; pass devices=")
    d = len(devs)
    if num_nodes is not None:
        while d > 1 and num_nodes % d != 0:
            d -= 1
    return FleetMesh(devices=tuple(devs[:d]), axis=axis)


def fleet_mesh_auto(num_nodes: int) -> FleetMesh | None:
    """``fleet_mesh`` for controllers: None unless sharding actually helps.

    Returns a mesh only when more than one CUDA device is visible *and* the
    fleet divides onto more than one of them; ``profile_fleet(mesh="auto")``
    uses this, so a one-card deployment keeps the unsharded path.
    """
    if torch.cuda.device_count() <= 1:
        return None
    fm = fleet_mesh(num_nodes)
    return fm if fm.num_devices > 1 else None


def reshard(tree: Any, mesh: FleetMesh | None = None, *, device=None) -> Any:
    """Re-place a live tree onto a (new) mesh mid-stream: mesh elasticity.

    Every leaf is copied to the host (the checkpoint; a ``Shards`` tree is
    joined there first) and placed again: split over ``mesh``, or, with
    ``mesh=None``, whole on ``device`` (default: the device the tree's first
    tensor lies on).  The values keep their bits; only where they live
    changes.
    """
    if device is None:
        device = _first_device(tree)
    host_copy = lambda t: t.to("cpu", copy=True)  # noqa: E731
    if isinstance(tree, Shards):
        host = _join([_tree_map(host_copy, s) for s in tree], torch.device("cpu"))
    else:
        host = _tree_map(host_copy, tree)
    if mesh is not None:
        return mesh.put(host)
    return _tree_map(lambda t: t.to(device), host)


class FleetTotals(NamedTuple):
    """Fleet-wide conserved-attribution totals (one controller-level view).

    ``per_fn.sum() + unattributed == attributed + unattributed`` equals the
    fleet's total measured active power-ticks.  Combined mode (§4.3) keeps
    the chip and 'rest' sides apart: ``per_fn``/``attributed`` cover the
    disaggregated rest power, ``chip_per_fn``/``chip_total`` the counter
    model's X_CPU (zeros in pure mode).
    """

    per_fn: torch.Tensor        # (M,) attributed power summed over nodes and ticks (W)
    attributed: torch.Tensor    # ()   total attributed power-ticks across the fleet
    unattributed: torch.Tensor  # ()   total unattributed power-ticks across the fleet
    cp_total: torch.Tensor      # ()   control-plane power summed over nodes (0 if absent)
    chip_per_fn: torch.Tensor   # (M,) counter-model chip power summed over nodes (W)
    chip_total: torch.Tensor    # ()   fleet chip-side total (0 in pure mode)


def _part(tp, ua, cpv, m, chip) -> FleetTotals:
    """Node-local (one shard's) totals; ``m`` is the tick mask or None,
    ``chip=None`` fills zeros."""
    if m is not None:
        tp = tp * m[..., None]
        ua = ua * m
    n_fns = tp.shape[-1]
    return FleetTotals(
        per_fn=tp.sum(dim=(0, 1)),
        attributed=tp.sum(),
        unattributed=ua.sum(),
        cp_total=cpv.sum(),
        chip_per_fn=tp.new_zeros((n_fns,)) if chip is None else chip.sum(dim=0),
        chip_total=tp.new_zeros(()) if chip is None else chip.sum(),
    )


def fleet_attribution_totals(
    tick_power: torch.Tensor,                # (B, T, M) conserved per-tick power
    unattributed: torch.Tensor,              # (B, T)
    cp_power: torch.Tensor | None = None,    # (B,) per-node control-plane power
    *,
    chip_power: torch.Tensor | None = None,  # (B, M) per-node per-function X_CPU (§4.3)
    mask: torch.Tensor | None = None,        # (B, T) tick validity for ragged fleets
    mesh: FleetMesh | None = None,
) -> FleetTotals:
    """Reduce per-node attribution to fleet totals (the reference's ``psum``).

    Unsharded this is a handful of sums.  With a ``FleetMesh`` every input
    is split over the node axis, each shard reduces its own node block on
    its device, and the partials are summed in shard order on the mesh's
    first device: the only cross-shard step of the sharded controller.
    ``mask`` excludes padded ticks from every total before the reduction;
    ``chip_power`` rides the same reduction into ``chip_per_fn`` /
    ``chip_total``.
    """
    cp = (
        tick_power.new_zeros((tick_power.shape[0],)) if cp_power is None else cp_power
    )
    if mask is not None:
        mask = mask.reshape(unattributed.shape).to(tick_power.dtype)
    if mesh is None:
        return _part(tick_power, unattributed, cp, mask, chip_power)
    mesh.validate(tick_power.shape[0])
    parts = [
        _part(*args)
        for args in mesh.split((tick_power, unattributed, cp, mask, chip_power))
    ]
    dev = mesh.devices[0]
    total = FleetTotals(*(v.to(dev) for v in parts[0]))
    for p in parts[1:]:
        total = FleetTotals(*(a + b.to(dev) for a, b in zip(total, p)))
    return total
