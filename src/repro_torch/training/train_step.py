"""The train step: loss, gradients and AdamW -- the twin of the reference's
``repro/training/train_step.py``.

``make_train_step`` closes over the ``ModelApi`` and the optimizer config
and returns ``(state, batch) -> (state, metrics)``.  The state's fp32
masters are read through ``models.common.ComputeView`` (each weight cast to
the compute dtype where it is used, as the reference casts at every use),
the gradients come from ``torch.autograd.grad`` in fp32 on the masters, and
``optimizer.update`` writes the new parameters and moments into the
state's own tensors.

The reference's XLA sharding and lowering tools -- ``abstract_state``,
``state_logical``, ``state_shardings``, ``batch_shardings``,
``abstract_batch`` and ``jit_train_step`` -- place the state on a device
mesh and lower the step for the dry-run; the port runs eagerly on one card
and has no twin of them (ROADMAP items 9.8 and 9.9).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import ComputeView, cast_masters, map_tree, materialize, tree_leaves
from repro_torch.models.model_zoo import ModelApi
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
    consumer in the reference is the dry run's ``--bf16-params``; no
    launcher or example of the port sets it until that twin exists.
    """
    cdt = compute_dtype(api.cfg)

    def grad_of(params, leaves, batch):
        tree = cast_masters(params, cdt) if cast_params else params
        loss, metrics = api.loss(ComputeView(tree, cdt), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        if accum_steps <= 1:
            loss, metrics, grads = grad_of(state.params, leaves, batch)
        else:
            micro = {k: torch.chunk(x, accum_steps, dim=0) for k, x in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            losses = []
            for i in range(accum_steps):
                loss_i, _, grads = grad_of(state.params, leaves, {k: x[i] for k, x in micro.items()})
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
