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
program does not have; they get no twin.  The dry-run slice (ROADMAP item
9.9) counts collective bytes on the traced step with
``torch.distributed.tensor.debug.CommDebugMode``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.common import map_tree


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
