"""Optimizer: AdamW with global-norm clipping and a warmup-cosine schedule,
plus the int8 error-feedback gradient compressor -- the twin of the
reference's ``repro/training/optimizer.py``.

Trees are the port's parameter trees: a ``ParamTree`` of fp32 masters, and
nested dicts with per-layer lists (``models.common.map_tree``) for the
gradients, the moments and the error buffers, all of one structure.  The
moments are fp32; ``count`` is a 0-dim int32 tensor on the parameters'
device, so the schedule and the bias corrections are computed there in
fp32, as the reference computes them, with no host read.

``update`` runs under ``torch.no_grad`` and writes the new parameters and
moments into the given tensors (the reference's launcher donates its state
to the jitted step; a 1.9e9-parameter model's masters and moments are
22.7 GB, which a functional copy would double).  The numbers are the
reference's, term for term.

A state placed on a mesh of several ranks (``train_step.place_state``)
holds ``DTensor`` parameters, gradients, moments and error buffers of one
placement per leaf: the reductions (the global norm, a leaf's amax) are
taken over the whole tensor (a ``DTensor`` reduction, then
``full_tensor``), and the elementwise update runs on each rank's local
block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import leaf_groups, map_tree, tree_leaves

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # int8 error-feedback gradient compression (across the "pod" axis on a pod).
    compress_grads: bool = False


class AdamState(NamedTuple):
    mu: Any        # first moment, same tree as params
    nu: Any        # second moment
    count: Tensor  # 0-dim int32 step
    err: Any       # error-feedback residuals (None when compression is off)


def _zeros(params) -> dict:
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _local(x: Tensor) -> Tensor:
    """This rank's block of a ``DTensor`` (the tensor itself, not a copy);
    a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _whole(x: Tensor) -> Tensor:
    """A reduction's value over the whole ``DTensor``; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def init(params, config: OptimizerConfig) -> AdamState:
    """Zero-initialised Adam state (plus the error buffer when compressing
    gradients) on the parameters' device."""
    device = tree_leaves(params)[0].device
    return AdamState(mu=_zeros(params), nu=_zeros(params), count=torch.zeros((), dtype=torch.int32, device=device),
                     err=_zeros(params) if config.compress_grads else None)


def schedule(step: Tensor, config: OptimizerConfig) -> Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``, in fp32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(config.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - config.warmup_steps) / max(config.total_steps - config.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    decay = config.min_lr_ratio + (1.0 - config.min_lr_ratio) * cos
    return config.learning_rate * warm * decay


def global_norm(tree) -> Tensor:
    """Global L2 norm over a gradient tree (fp32 accumulation)."""
    return torch.sqrt(torch.sum(torch.stack([_whole(torch.sum(torch.square(x.to(torch.float32))))
                                             for x in tree_leaves(tree)])))


def clip_by_global_norm(grads, max_norm: float):
    """Scale grads onto the ``max_norm`` ball; returns (clipped, pre-clip
    norm).  Placed gradients come back as their local blocks."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda g: _local(g) * scale, grads), norm


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------


def quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    return _quantize(x, scale), scale


def _quantize(x: Tensor, scale: Tensor) -> Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    """Reconstruct float32 values from an int8 payload and its scale."""
    return q.to(torch.float32) * scale


def _like(ref: Tensor, local: Tensor) -> Tensor:
    """``local`` as a ``DTensor`` of ``ref``'s placement when ``ref`` is one."""
    if isinstance(ref, DTensor):
        return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False)
    return local


def ef_compress(grads, err):
    """Error-feedback int8 round trip: g' = deq(quant(g + err)), and the
    residual (g + err) - g' carried to the next step, so the compression is
    unbiased over time (EF-SGD).  On a pod it wraps the cross-pod
    all-reduce; on one device it is the same arithmetic.  The scale is per
    reference leaf: one over all layers of a per-layer list, which the
    reference holds as one stacked tensor.  Returns (new grads, new err)."""
    new: dict[int, Tensor] = {}
    for (_, gs, _), (_, es, _) in zip(leaf_groups(grads), leaf_groups(err), strict=True):
        targets = [g.to(torch.float32) + e for g, e in zip(gs, es)]
        amax = torch.max(torch.stack([_whole(torch.max(torch.abs(t))) for t in targets]))
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for g, e, target in zip(gs, es, targets):
            deq = _like(target, dequantize_int8(_quantize(_local(target), scale), scale))
            new[id(g)], new[id(e)] = deq.to(g.dtype), (target - deq).to(e.dtype)
    return map_tree(lambda g: new[id(g)], grads), map_tree(lambda e: new[id(e)], err)


# ---------------------------------------------------------------------------
# AdamW update
# ---------------------------------------------------------------------------


@torch.no_grad()
def update(grads, state: AdamState, params, config: OptimizerConfig):
    """One AdamW step.  Returns (params, new state, stats): ``params`` and
    the moments updated in place (the same tensors), a new ``count`` and
    error buffer; stats are ``grad_norm`` and ``lr`` (0-dim tensors)."""
    new_err = state.err
    if config.compress_grads and state.err is not None:
        grads, new_err = ef_compress(grads, state.err)
    grads, grad_norm = clip_by_global_norm(grads, config.clip_norm)
    count = state.count + 1
    step_f = count.to(torch.float32)
    lr = schedule(step_f, config)
    b1, b2 = config.beta1, config.beta2
    bc1 = 1.0 - b1 ** step_f
    bc2 = 1.0 - b2 ** step_f
    for p, g, m, v in zip(*(map(_local, tree_leaves(t)) for t in (params, grads, state.mu, state.nu)), strict=True):
        g32 = g.to(torch.float32)
        m.copy_(b1 * m + (1.0 - b1) * g32)
        v.copy_(b2 * v + (1.0 - b2) * g32 * g32)
        step = (m / bc1) / (torch.sqrt(v / bc2) + config.eps)
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (step + config.weight_decay * p32))
    return params, AdamState(mu=state.mu, nu=state.nu, count=count, err=new_err), {"grad_norm": grad_norm, "lr": lr}
