"""Tensor parallelism over the "model" mesh axis: the collectives that split
a product between the "model" ranks of a token shard.

This module is the port's stand-in for the partitioning that GSPMD does
for the reference (``jax.jit`` with sharded weights splits every product
whose weight the rules shard over "model"); it has no file twin in the
reference.  The placed train step and the dry run's serve programs read
the split consumers' weights as this rank's "model" block
(``sharding.local_view(split=...)``), and the model code runs the products
on those blocks (``models/attention.py``, ``mlp.py``, ``transformer.py``,
``ssm.py``, ``xlstm.py``, ``common.py``'s CE and split RMSNorm), joining
them with the four operations below, as
autograd Functions after Megatron-LM's f/g pairs, and a fifth:

- ``copy_to_model``: identity forward, all-reduce backward (the input of a
  column-parallel product, whose gradient each rank holds a part of);
- ``reduce_from_model``: all-reduce forward, identity backward (the output
  of a row-parallel product);
- ``gather_from_model``: all-gather along a dim forward, this rank's slice
  backward;
- ``scatter_to_model``: this rank's slice forward, all-gather backward;
- ``sum_over_model``: all-reduce forward and backward (a sum every rank
  reads only in part: a split RMSNorm's sum of squares, whose gradient
  each rank holds a part of; the mLSTM's gates of a rank's heads).

The group, rank and size are the "model" dimension's of the mesh that
``sharding.use_rules`` made active; only ``all_reduce`` and
``all_gather_into_tensor`` are issued.  Every "model" rank issues the same
collectives in the same order, in the forward, in a remat block's
recompute (run under the forward's rule context, ``common.maybe_remat``)
and in the backward.  A consumer recognises a split weight by its width:
``split_of(local, full)`` is None when the rank holds the whole dim, so at
"model" size 1, outside a rule context and on whole weights the model code
takes its unsplit path unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd


class ModelAxis(NamedTuple):
    """The active mesh's "model" dimension as this rank sees it."""

    group: object
    rank: int
    size: int


def model_axis() -> ModelAxis | None:
    """The "model" group, rank and size of the active rule context's mesh,
    or None outside a context, on a mesh without a "model" axis, or at
    size 1."""
    active = shd._active()
    if active is None:
        return None
    mesh = active[0]
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names:
        return None
    size = mesh.size(names.index("model"))
    if size == 1:
        return None
    return ModelAxis(mesh.get_group("model"), mesh.get_local_rank("model"), size)


def split_of(local: int, full: int) -> ModelAxis | None:
    """The model axis a dim of ``full`` entries is split over when this rank
    holds ``local`` of them, or None when it holds them all."""
    if local == full:
        return None
    axis = model_axis()
    if axis is None or local * axis.size != full:
        raise ValueError(f"a block of {local} of {full} entries is no 'model' block of the active mesh "
                         f"(model axis: {axis})")
    return axis


def _all_reduce(x: torch.Tensor, axis: ModelAxis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def _all_gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``, in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.axis, ctx.dim), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over "model"."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Summed over "model" forward; the gradient passes as it is."""
    return _ReduceFromModel.apply(x, axis)


def sum_over_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Summed over "model" forward, and the gradient too: for a sum of
    parts that each rank then reads in a part of its own."""
    return _SumOverModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """The "model" ranks' blocks joined along ``dim``; the gradient is this
    rank's block."""
    return _GatherFromModel.apply(x, axis, dim % x.ndim)


def scatter_to_model(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """This rank's block along ``dim``; the gradient is all-gathered."""
    return _ScatterToModel.apply(x, axis, dim % x.ndim)


def max_over_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The elementwise max over "model", outside autograd (a softmax's
    shift, whose gradient cancels)."""
    return _all_reduce(x.detach(), axis, dist.ReduceOp.MAX)
