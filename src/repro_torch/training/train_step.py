"""The train step: loss, gradients and AdamW, with the state placed on a
mesh -- the twin of the reference's ``repro/training/train_step.py``.

``make_train_step`` closes over the ``ModelApi`` and the optimizer config
and returns ``(state, batch) -> (state, metrics)``.  The state's fp32
masters are read through ``models.common.ComputeView`` (each weight cast to
the compute dtype where it is used, as the reference casts at every use),
the gradients come from ``torch.autograd.grad`` in fp32 on the masters, and
``optimizer.update`` writes the new parameters and moments into the
state's own tensors.

**Placement.**  ``state_logical``, ``state_shardings`` and
``batch_shardings`` resolve the reference's logical-axis rules over the
port's state layout (a per-layer list's leaves drop the stacked axis, which
every rule replicates, so their specs are the reference's with that entry
dropped), and ``place_state`` distributes each leaf onto its sharding.  On
a mesh of one device every spec places the whole tensor on that device, so
there ``place_state`` leaves plain tensors: a one-device ``DTensor`` would
only add host dispatch to each of a training step's launches.  On a mesh of
several ranks the parameters and moments become ``DTensor``s (``count``
stays a plain scalar, equal on every rank), and the step runs as each
rank's local program:

- each weight is gathered on the token axes where the forward reads it
  (``distributed.sharding.local_view``, the gather rule the dry run's serve
  programs share; an all-gather whose gradient comes back as a partial sum
  over the token axes, reduced and scattered onto the weight's own
  placement -- FSDP's pattern);
- the products split over "model" as the rules place their weights
  (``distributed.tensor_parallel``): the leaves of ``models.common.
  split_mask`` -- the attention projections, the dense MLP, the embedding
  and the unembedding, the Mamba2 and mLSTM blocks' leaves and the sLSTM's
  input product -- are read as this rank's "model" block, whose gradient
  is that block's and needs no reduction over "model"; the fused ones
  (Mamba2's ``w_zx`` and ``w_bc``, the mLSTM's ``w_in`` and ``b_if``) are
  gathered and read as the rank's block of each part, their gradient summed
  over "model".  Attention and the Mamba2 and mLSTM blocks run on the
  rank's heads, the MLP column then row parallel, the sLSTM's input
  product column parallel, the logits and the CE on the rank's vocabulary
  block.  The other leaves (the router, the sLSTM's recurrence, the norm
  gains) are gathered whole over "model" too, and their products are the
  same on every "model" rank; expert weights on the MoE block's
  expert-parallel path are gathered by that path to the rank's own
  experts.  Under rules that shard the batch over "model"
  (``ZERO3_RULES``) "model" is a token axis and nothing is split;
- the batch is the rank's block on the token axes ("pod", "data"), the
  same on every "model" rank;
- each rank's loss is weighted by its share of the valid tokens, so the
  sum over token shards is the global mean loss, whose value is reported.

**Dry run.**  ``abstract_state`` and ``abstract_batch`` are the state's
and a batch's ``TensorSpec`` trees (nothing allocated), and
``jit_train_step`` binds the step to a mesh's rules for a shape:
``launch.dryrun`` places fake blocks by those specs and runs the step once
on them, over a fake world of the production mesh's size.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed import sharding as shd
from repro_torch.models.common import (
    ComputeView, cast_masters, layer_specs, logical_axes, map_tree, materialize, split_mask, tree_leaves,
)
from repro_torch.models.model_zoo import ModelApi, TensorSpec
from repro_torch.models.transformer import compute_dtype
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any          # ParamTree of fp32 masters that require grad
    opt: opt.AdamState


def init_state(api: ModelApi, generator: torch.Generator, config: opt.OptimizerConfig) -> TrainState:
    """fp32 masters drawn from ``generator`` (on its device) and a zero
    optimizer state."""
    params = materialize(api.params_def, generator, torch.float32, trainable=True)
    return TrainState(params=params, opt=opt.init(params, config))


def abstract_state(api: ModelApi, config: opt.OptimizerConfig) -> TrainState:
    """``TensorSpec`` twin of the train state (the dry run: no allocation):
    fp32 parameters and moments, the error buffer when compressing
    gradients, a 0-dim int32 ``count`` -- the reference's leaves, a
    per-layer list's leaves with the stacked axis dropped."""
    params = map_tree(lambda p: TensorSpec(p.shape, torch.float32, p.axes), layer_specs(api.params_def))
    return TrainState(params=params, opt=opt.AdamState(mu=params, nu=params, count=TensorSpec((), torch.int32, ()),
                                                       err=params if config.compress_grads else None))


def state_logical(api: ModelApi, config: opt.OptimizerConfig) -> TrainState:
    """Logical-axis tree matching ``TrainState`` (the moments mirror the
    parameters)."""
    axes = logical_axes(api.params_def)
    return TrainState(params=axes, opt=opt.AdamState(mu=axes, nu=axes, count=(),
                                                     err=axes if config.compress_grads else None))


def state_shardings(api: ModelApi, config: opt.OptimizerConfig, mesh, rules) -> TrainState:
    """``NamedSharding`` tree for the train state under (mesh, rules).
    ``count`` gets ``None``: the step counter stays a plain scalar, equal
    on every rank (the reference's replicated 0-dim leaf)."""
    specs = layer_specs(api.params_def)
    shaped = TrainState(params=specs, opt=opt.AdamState(mu=specs, nu=specs, count=torch.zeros(()),
                                                        err=specs if config.compress_grads else None))
    out = shd.tree_shardings(state_logical(api, config), shaped, mesh, rules)
    return out._replace(opt=out.opt._replace(count=None))


def batch_shardings(spec_tree: Any, mesh, rules) -> Any:
    """``NamedSharding`` tree for a host-batch ``TensorSpec`` tree."""
    return {k: shd.sharding_for(s.axes, s.shape, mesh, rules) for k, s in spec_tree.items()}


def abstract_batch(spec_tree: Any) -> dict:
    """The abstract tree of a host batch: its ``TensorSpec``s, which are
    the port's shape-and-dtype structs already."""
    return dict(spec_tree)


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """Distribute each leaf of ``state`` onto its sharding (the reference's
    ``device_put(state, shardings)``): plain tensors on a one-device mesh,
    ``DTensor``s from each rank's block otherwise."""
    return shd.place_tree(state, shardings)


def _placed_mesh(params):
    """The mesh of a placed state's parameters, or None when they are plain."""
    first = tree_leaves(params)[0]
    return first.device_mesh if isinstance(first, DTensor) else None


def _tokens_on_model(batch: dict) -> bool:
    """True when a placed batch is split over "model": the axis then
    carries tokens (``ZERO3_RULES``), not a tensor-parallel split."""
    return any(isinstance(v, DTensor) and any(
        n == "model" and isinstance(p, Shard) for n, p in zip(v.device_mesh.mesh_dim_names, v.placements))
        for v in batch.values())


def _token_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's token axes ("pod", "data")."""
    x = x.clone()
    for axis in mesh.mesh_dim_names:
        if axis in ("pod", "data"):
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def make_train_step(api: ModelApi, config: opt.OptimizerConfig, *, accum_steps: int = 1, cast_params: bool = False):
    """(state, batch) -> (state, metrics); the state is updated in place.

    ``accum_steps > 1`` splits the global batch along its first axis into
    that many microbatches and averages their gradients (the mean of
    microbatch gradients is the full-batch gradient of a mean loss), so
    activation memory scales down by the factor; the loss reported is the
    mean of the microbatch losses.

    ``cast_params`` is the reference's option of the same name: the fp32
    masters of two or more dims are cast to the compute dtype once, before
    the forward, instead of at each use; a weight used at several places
    (a tied embedding, zamba2's shared block) then sums its gradient in the
    compute dtype before the cast back, as the reference's does.  Its one
    consumer, in the reference and here, is the dry run's
    ``--bf16-params``.

    A state placed on a mesh of several ranks (``place_state``) runs as
    the module docstring says; its batch is the ``batch_iterator(shardings=)``
    one."""
    cdt = compute_dtype(api.cfg)
    logical = logical_axes(api.params_def)
    ep = api.cfg.family == "moe" and api.cfg.router_impl != "ragged"
    split = split_mask(logical)

    def grad_of(params, leaves, batch, tp_split):
        mesh = _placed_mesh(params)
        if mesh is not None:
            params = shd.local_view(params, logical, mesh, ep=ep and shd._active() is not None,
                                    split=split if tp_split else None)
        tree = cast_masters(params, cdt) if cast_params else params
        loss, metrics = api.loss(ComputeView(tree, cdt), batch)
        if mesh is not None:  # this rank's share of the global mean
            tokens = metrics["tokens"].detach()
            loss = loss * (tokens / _token_sum(tokens, mesh))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        loss = loss.detach() if mesh is None else _token_sum(loss.detach(), mesh)
        return loss, {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        tp_split = shd._active() is not None and not _tokens_on_model(batch)
        batch = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}  # this rank's block
        if accum_steps <= 1:
            loss, metrics, grads = grad_of(state.params, leaves, batch, tp_split)
        else:
            micro = {k: torch.chunk(x, accum_steps, dim=0) for k, x in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            losses = []
            for i in range(accum_steps):
                loss_i, _, grads = grad_of(state.params, leaves, {k: x[i] for k, x in micro.items()}, tp_split)
                for a, g in zip(acc, grads):
                    a.add_(g.to(torch.float32))
                losses.append(loss_i)
                del grads
            grads = [a / accum_steps for a in acc]
            del acc
            loss, metrics = torch.mean(torch.stack(losses)), {}
        it = iter(grads)
        grad_tree = map_tree(lambda _: next(it), state.params)
        del grads
        params, new_opt, stats = opt.update(grad_tree, state.opt, state.params, config)
        return TrainState(params=params, opt=new_opt), {**metrics, **stats, "loss": loss}

    return train_step


def jit_train_step(api: ModelApi, config: opt.OptimizerConfig, mesh, rules, *, accum_steps: int = 1,
                   cast_params: bool = False):
    """The placed train step and the state shardings it runs on -- the
    reference's ``(compile_for, st_sh)``.  ``compile_for(shape)`` gives
    ``(step, specs)``: the step bound to ``use_rules(mesh, rules)`` (torch
    runs eagerly, so binding takes the place of ``jax.jit``'s shardings)
    and the shape's batch ``TensorSpec``s.  ``accum_steps`` and
    ``cast_params`` are ``make_train_step``'s."""
    step = make_train_step(api, config, accum_steps=accum_steps, cast_params=cast_params)
    st_sh = state_shardings(api, config, mesh, rules)

    def compile_for(shape):
        def placed_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
            with shd.use_rules(mesh, rules):
                return step(state, batch)

        return placed_step, api.train_inputs(shape)

    return compile_for, st_sh
