"""Model substrate: parameter declarations, their materialisation, norms and
rotary embeddings -- the twin of the reference's ``repro/models/common.py``.

Parameters are declared as ``Param`` leaves (shape + logical axes + init
law) in the reference's tree layout, with per-layer leaves stacked along a
leading axis (``stack_params``: "layers" of a decoder, "pairs" of the
xLSTM stack).  ``materialize`` draws every leaf with its init law from an
explicit ``torch.Generator`` and returns a ``ParamTree``: an ``nn.Module``
that holds the same leaves under the reference's names (``p["wq"]``,
``"bq" in p``), with each stacked subtree split into an ``nn.ModuleList``
of per-layer trees, so the forward pass is a Python loop over layers in
place of ``lax.scan``.

Weights are stored in the compute dtype.  The reference keeps fp32 masters
and casts each weight with ``.astype(dt)`` at every use; casting once at
load gives exactly the same values without re-reading the fp32 masters on
every decode step.  The leaves the reference reads in fp32 stay fp32
(``keeps_fp32``): norm gains, the MoE router and the xLSTM gate biases and
sLSTM recurrence.  The loss functions wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Param:
    """Declarative parameter leaf."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # multiplier on the init law's std
    fan_in: int | None = None   # override fan-in for 'normal'

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable[[str, Any], Any], tree: dict) -> dict:
    """Apply ``fn(leaf_name, leaf)`` to every non-dict leaf of a nested dict,
    in sorted key order (the order in which JAX flattens a dict)."""
    return {
        k: tree_map(fn, tree[k]) if isinstance(tree[k], dict) else fn(k, tree[k])
        for k in sorted(tree)
    }


def param_count(tree: dict) -> int:
    """Total element count over a ``Param`` spec tree."""
    sizes = []
    tree_map(lambda _, p: sizes.append(math.prod(p.shape)), tree)
    return sum(sizes)


def stack_params(tree: dict, n: int) -> dict:
    """Stack a per-layer Param tree ``n`` times along a leading "layers" axis.

    Fan-in for 'normal' init is pinned to the *unstacked* value so the init
    law is identical to materializing n independent layers.
    """

    def _stack(_, p: Param) -> Param:
        fan_in = p.fan_in
        if fan_in is None and p.init == "normal":
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        return Param((n, *p.shape), ("layers", *p.axes), p.init, p.scale, fan_in)

    return tree_map(_stack, tree)


#: Leaves, besides the ``ln*`` norm gains, that the reference reads in fp32
#: whatever the compute dtype: the xLSTM norm gains, the MoE router, the
#: mLSTM gate bias and the sLSTM recurrence and bias.
_FP32_LEAVES = frozenset({"gamma", "router", "b_if", "r", "b"})

#: Subtrees stacked along a leading per-layer axis.
_STACKED = ("layers", "pairs")


def keeps_fp32(name: str) -> bool:
    """Leaves that stay fp32 at load: the norm gains (``ln``, ``ln1``,
    ``ln2``, ``ln_f``, ``gamma``) and ``_FP32_LEAVES``."""
    return name.startswith("ln") or name in _FP32_LEAVES


class ParamTree(nn.Module):
    """Parameters addressed like the reference's dict tree.

    ``tree`` is a nested dict of tensors; a list value becomes an
    ``nn.ModuleList`` of trees (the per-layer blocks).  Parameters carry no
    gradient: the serving slice only runs forward.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def to_tree(self) -> dict:
        """The nested dict of tensors this tree was built from."""
        out: dict = {name: p.data for name, p in self._parameters.items()}
        for name, mod in self._modules.items():
            out[name] = [m.to_tree() for m in mod] if isinstance(mod, nn.ModuleList) else mod.to_tree()
        return out


def _unstack_layers(tree: dict) -> dict:
    """Split each stacked subtree (``_STACKED``) into a list of per-layer
    trees (views of the stacked tensors, no copy)."""

    def take(node, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

    def unstack(stacked):
        first = stacked
        while isinstance(first, dict):
            first = next(iter(first.values()))
        return [take(stacked, i) for i in range(first.shape[0])]

    return {k: unstack(v) if k in _STACKED else v for k, v in tree.items()}


def _truncated_normal(shape, generator: torch.Generator) -> Tensor:
    """Standard normal truncated to [-2, 2], as ``jax.random.truncated_normal``
    draws it: the inverse CDF of a uniform draw in [Phi(-2), Phi(2)]."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(lo, hi, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _leaf_init(p: Param, generator: torch.Generator) -> Tensor:
    dev = generator.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=torch.float32, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=torch.float32, device=dev)
    if p.init == "embed":
        x = torch.empty(p.shape, dtype=torch.float32, device=dev)
        return x.normal_(generator=generator).mul_(p.scale)
    # truncated-normal fan-in scaling (maxtext-style default)
    fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2 else p.shape[-1])
    std = p.scale / math.sqrt(max(fan_in, 1))
    return _truncated_normal(p.shape, generator).mul_(std)


def _cast(node, dtype: torch.dtype, name: str = ""):
    """Cast every tensor of a nested dict/list tree to ``dtype``, the
    ``keeps_fp32`` leaves to fp32 (``.to`` returns the tensor itself when
    nothing changes)."""
    if isinstance(node, dict):
        return {k: _cast(v, dtype, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast(v, dtype, name) for v in node]
    return node.to(torch.float32 if keeps_fp32(name) else dtype)


def load_params(tree: dict, dtype: torch.dtype) -> ParamTree:
    """A ``ParamTree`` from a nested dict of tensors with stacked (L, ...)
    "layers" or "pairs" leaves: weights cast to ``dtype``, the
    ``keeps_fp32`` leaves fp32."""
    return ParamTree(_unstack_layers(_cast(tree, dtype)))


def materialize(tree: dict, generator: torch.Generator, dtype: torch.dtype = torch.float32) -> ParamTree:
    """Instantiate every Param leaf with its init law, drawn in fp32 on the
    generator's device in sorted-key order and cast leaf by leaf to ``dtype``
    (the ``keeps_fp32`` leaves stay fp32).  The draws differ from the reference's
    ``jax.random`` bits; the laws are the same."""
    return load_params(tree_map(lambda name, p: _cast(_leaf_init(p, generator), dtype, name), tree), dtype)


def cast_params(params: ParamTree, dtype: torch.dtype) -> ParamTree:
    """The same parameters with every weight cast to ``dtype`` (the
    ``keeps_fp32`` leaves stay fp32): the compute-dtype copy of fp32
    masters."""
    return ParamTree(_cast(params.to_tree(), dtype))


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    """(head_dim/2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary position embedding.

    Args:
      x: (..., S, H, head_dim)
      positions: (..., S) integer positions (broadcastable to x[..., :, 0, 0]).
    """
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                                # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: Tensor, cap: float) -> Tensor:
    """Gemma-style tanh logit soft-capping; identity when ``cap <= 0``."""
    if cap <= 0.0:
        return logits
    return torch.tanh(logits / cap) * cap
