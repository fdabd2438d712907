"""Collectives: the int8 compressed all-reduce over the "pod" axis -- the
twin of the reference's ``repro/distributed/collectives.py``.

``compressed_psum`` quantizes a rank's tensor to int8 with one scale shared
across the group (a MAX all-reduce of the amax first), sums the int8
payload as int32 (so 2-256 participants cannot overflow) and dequantizes:
the collective counterpart of ``training.optimizer.ef_compress``.  The
reference runs it under ``shard_map`` over the "pod" mesh axis; here each
rank is a process and the axis is the ``ProcessGroup`` of that mesh
dimension (``make_compressed_pod_mean``).

The reference's HLO-text parsers (``collective_bytes``,
``collective_bytes_structured``) read XLA's compiled text, which a torch
program does not have.  Their twin is ``CollectiveCounter``, a dispatch
mode over a traced step (``launch.dryrun`` runs it on fake tensors): it
sums each collective's output bytes by kind -- the reference's convention
and kind names -- and by mesh axis.  The trace is unrolled (each layer's
collectives are seen as often as they run), so everything lands in the
structured record's "top" bucket and its "body" bucket stays empty: the
roofline's loop-trip multiplier applies to nothing.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models.common import map_tree

_funcol = torch.ops._c10d_functional
_c10d = torch.ops.c10d

#: Collective op -> the reference's kind name.  A functional collective's
#: output is its return value; a c10d op writes its first argument.
_FUNCOL_KINDS = {
    _funcol.all_gather_into_tensor: "all-gather",
    _funcol.all_gather_into_tensor_coalesced: "all-gather",
    _funcol.all_reduce: "all-reduce",
    _funcol.all_reduce_coalesced: "all-reduce",
    _funcol.reduce_scatter_tensor: "reduce-scatter",
    _funcol.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _funcol.all_to_all_single: "all-to-all",
    torch.ops._c10d_functional_autograd.all_to_all_single: "all-to-all",
}
_C10D_KINDS = {
    _c10d.allgather_: "all-gather",
    _c10d._allgather_base_: "all-gather",
    _c10d.allgather_into_tensor_coalesced_: "all-gather",
    _c10d.allreduce_: "all-reduce",
    _c10d.allreduce_coalesced_: "all-reduce",
    _c10d.reduce_scatter_: "reduce-scatter",
    _c10d._reduce_scatter_base_: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced_: "reduce-scatter",
    _c10d.alltoall_: "all-to-all",
    _c10d.alltoall_base_: "all-to-all",
    _c10d.send: "collective-permute",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _group_name(args) -> str | None:
    """The group name of a c10d op's process-group argument (a boxed
    ``ProcessGroup``)."""
    from torch._C._distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return ProcessGroup.unbox(a).group_name
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives a step issues while it is active: output
    bytes and calls by kind ("all-gather", "all-reduce", "reduce-scatter",
    "all-to-all", "collective-permute"), and bytes by mesh axis.  ``mesh``
    names the axes (its dims' process groups); a group of no mesh axis is
    counted under "world".  Like ``CommDebugMode`` it lets a ``DTensor``
    op run first and counts the collectives it desugars into, on this
    rank's local tensors."""

    def __init__(self, mesh=None):
        super().__init__()
        self.axis_of = {}
        if mesh is not None:
            for axis in mesh.mesh_dim_names:
                self.axis_of[mesh.get_group(axis).group_name] = axis
        self.bytes: dict[str, int] = defaultdict(int)
        self.calls: Counter = Counter()
        self.by_axis: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if DTensor in types:
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet in _FUNCOL_KINDS:
            self._add(_FUNCOL_KINDS[packet], _nbytes(out), args[-1])
        elif packet in _C10D_KINDS:
            self._add(_C10D_KINDS[packet], _nbytes(args[0]), _group_name(args))
        return out

    def _add(self, kind: str, nbytes: int, group_name) -> None:
        self.bytes[kind] += nbytes
        self.calls[kind] += 1
        self.by_axis[self.axis_of.get(group_name, "world")] += nbytes

    def collective_bytes(self) -> dict[str, int]:
        """{kind: bytes, ..., "total": bytes}, the reference's record."""
        out = dict(self.bytes)
        out["total"] = sum(out.values())
        return out

    def collective_bytes_structured(self) -> dict[str, dict[str, int]]:
        """The reference's {"top": ..., "body": ...}: an unrolled trace has
        no loop body, so all of it is "top"."""
        return {"top": self.collective_bytes(), "body": {}}


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized sum of ``x`` over the ranks of ``group``, in fp32.

    Every rank calls it with its own ``x`` of one shape.  The payload that
    crosses ranks is int8 values (summed as int32) and one fp32 scale,
    ``max(amax, 1e-12) / 127`` of the group-wide amax, so dequantization is
    exact with respect to the integer sum; the error is at most one scale
    step per participant."""
    amax = torch.max(torch.abs(x)).to(torch.float32)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    acc = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8).to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc.to(torch.float32) * scale


def make_compressed_pod_mean(mesh, axis: str = "pod"):
    """A tree-mean over ``mesh``'s ``axis`` with int8 payloads: each leaf
    ``compressed_psum``'d over that mesh dimension's group and divided by
    its size.  Leaves are this rank's tensors (the reference's replicated
    in-spec)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def tree_mean(tree: Any) -> Any:
        return map_tree(lambda v: compressed_psum(v, group) / n, tree)

    return tree_mean
