"""Model substrate: parameter declarations, their materialisation, norms and
rotary embeddings -- the twin of the reference's ``repro/models/common.py``.

Parameters are declared as ``Param`` leaves (shape + logical axes + init
law) in the reference's tree layout, with per-layer leaves stacked along a
leading axis (``stack_params``: "layers" of a decoder or of the hybrid's
Mamba2 backbone, "pairs" of the xLSTM stack, "enc_layers" and "dec_layers"
of the encoder-decoder).  ``materialize`` draws every leaf with its init law from an
explicit ``torch.Generator`` and returns a ``ParamTree``: an ``nn.Module``
that holds the same leaves under the reference's names (``p["wq"]``,
``"bq" in p``), with each stacked subtree split into an ``nn.ModuleList``
of per-layer trees, so the forward pass is a Python loop over layers in
place of ``lax.scan``.

Serving stores weights in the compute dtype.  The reference keeps fp32
masters and casts each weight with ``.astype(dt)`` at every use; casting
once at load gives exactly the same values without re-reading the fp32
masters on every decode step.  The leaves the reference reads in fp32 stay
fp32 (``keeps_fp32``): norm gains, the MoE router, the xLSTM gate biases
and sLSTM recurrence, and the Mamba2 decay, step bias, skip and gate norm.

Training keeps fp32 masters that require grad (``materialize(...,
trainable=True)``) and the forward reads them through a ``ComputeView``,
which casts each leaf where it is read, as the reference does; the casts
are autograd operations, so the gradients land on the masters in fp32.
``maybe_remat`` is the reference's activation-checkpoint policy, and
``cross_entropy_loss`` / ``chunked_lm_loss`` its masked LM losses.
``tree_leaves``, ``map_tree`` and ``leaf_groups`` walk a parameter or
train-state tree in the reference's flattening order (sorted dict keys),
``leaf_groups`` under the reference's ``keystr`` paths with the per-layer
lists stacked back along their leading axis.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.spans import span

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


def layer_specs(tree: dict) -> dict:
    """A ``Param`` spec tree in the port's state layout: each stacked
    subtree (``_STACKED``) becomes a list of per-layer trees whose leaves
    drop the leading per-layer axis.  Leaves keep their shape and logical
    axes, so the tree maps 1:1 onto a ``ParamTree``'s leaves."""

    def per_layer(node: dict) -> list:
        first = node
        while isinstance(first, dict):
            first = next(iter(first.values()))
        layer = tree_map(lambda _, p: dataclasses.replace(p, shape=p.shape[1:], axes=p.axes[1:]), node)
        return [layer] * first.shape[0]

    return {k: per_layer(v) if k in _STACKED else v for k, v in tree.items()}


def logical_axes(tree: dict) -> dict:
    """Logical-axis tuples of a ``Param`` spec tree, in the port's state
    layout (``layer_specs``).  The reference's stacked leaves carry a
    leading "layers"-like axis, which every rule table replicates, so a
    per-layer leaf's spec is the reference's with that first entry dropped."""
    return map_tree(lambda p: p.axes, layer_specs(tree))


#: Leaves the tensor-parallel consumers read as this rank's "model" block
#: (``distributed.tensor_parallel``), wherever they stand outside the
#: blocks of ``BLOCK_SPLITS``: the attention projections and biases, the
#: dense MLP's products (not the MoE experts', whose leading axis is
#: "expert"), the embedding and unembedding, the attention KV caches
#: (``k``/``v``, deepseek's ``k0``/``v0``, zamba2's ``attn_k``/``attn_v``,
#: seamless's ``cross_k``/``cross_v``) and the int8 cache's row scales, and
#: the recurrent caches on the rank's heads or channels: zamba2's ``ssm_h``
#: and ``conv``, the mLSTM's ``m``.  The MoE router and the sLSTM's state
#: are read whole.
SPLIT_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up", "w_down", "embed", "unembed",
                          "k", "v", "k0", "v0", "attn_k", "attn_v", "cross_k", "cross_v", "k_scale", "v_scale",
                          "ssm_h", "conv", "m"})

#: The recurrent blocks' leaves, keyed by their block (the parent key in
#: the tree): 1 for a leaf read as its "model" block, ``g`` > 1 for a fused
#: leaf whose split dim is ``g`` equal groups (``[z | xin]``, B then C,
#: ``[xin | z]``, the i then f gate biases), read as this rank's block of
#: each group, so that a rank's columns are its own heads' or channels'.
#: The Mamba2 block's leaves all split; the mLSTM's but its ``ln``; the
#: sLSTM's input product ``w_x`` alone (its recurrence ``r``, ``b``, norm
#: and ``w_out`` on ("embed", "embed2") stay whole).
BLOCK_SPLITS = {
    "mamba": {"w_zx": 2, "w_bc": 2, "w_dt": 1, "dt_bias": 1, "a_log": 1, "d_skip": 1, "conv_w": 1, "conv_b": 1,
              "gamma_gate": 1, "w_out": 1},
    "m": {"w_in": 2, "w_qkv": 1, "w_if": 1, "b_if": 2, "gamma": 1, "w_out": 1},
    "s": {"w_x": 1},
}


def split_mask(logical_tree) -> Any:
    """A tree of ints matching a logical-axis tree (``logical_axes``, or a
    cache's ``{name: axes}``) -- the ``split`` argument of
    ``distributed.sharding.local_view``: 0 for a leaf read whole, 1 for one
    read as its "model" block, ``g`` for a fused leaf of ``g`` groups.  A
    leaf of a ``BLOCK_SPLITS`` block is keyed by its block and name, any
    other by its name (``SPLIT_LEAVES``), experts excepted."""

    def walk(node, parent, name):
        if isinstance(node, dict):
            return {k: walk(v, name, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, parent, name) for v in node]
        if parent in BLOCK_SPLITS:
            return BLOCK_SPLITS[parent].get(name, 0)
        return int(name in SPLIT_LEAVES and tuple(node[:1]) != ("expert",))

    return walk(logical_tree, "", "")


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
#: mLSTM gate bias and the sLSTM recurrence and bias, the Mamba2 block's
#: ``a_log``, ``dt_bias``, ``d_skip`` and gate norm ``gamma_gate``, and the
#: encoder's final norm ``enc_ln_f``.
_FP32_LEAVES = frozenset({"gamma", "router", "b_if", "r", "b", "a_log", "dt_bias", "d_skip", "gamma_gate",
                          "enc_ln_f"})

#: Subtrees stacked along a leading per-layer axis.
_STACKED = ("layers", "pairs", "enc_layers", "dec_layers")


def keeps_fp32(name: str) -> bool:
    """Leaves that stay fp32 at load: the norm gains (``ln``, ``ln1``,
    ``ln2``, ``ln_x``, ``ln_f``, ``gamma``, ``enc_ln_f``) and ``_FP32_LEAVES``."""
    return name.startswith("ln") or name in _FP32_LEAVES


class ParamTree(nn.Module):
    """Parameters addressed like the reference's dict tree.

    ``tree`` is a nested dict of tensors; a list value becomes an
    ``nn.ModuleList`` of trees (the per-layer blocks).  Serving's trees
    (``load_params``, ``cast_params``) carry no gradient; a ``trainable``
    tree (the training path's fp32 masters) requires grad on every leaf.
    """

    def __init__(self, tree: dict, *, trainable: bool = False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value, trainable=trainable))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v, trainable=trainable) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=trainable))

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


def materialize(tree: dict, generator: torch.Generator, dtype: torch.dtype = torch.float32, *,
                trainable: bool = False) -> ParamTree:
    """Instantiate every Param leaf with its init law, drawn in fp32 on the
    generator's device in sorted-key order and cast leaf by leaf to ``dtype``
    (the ``keeps_fp32`` leaves stay fp32).  The draws differ from the reference's
    ``jax.random`` bits; the laws are the same.  ``trainable`` (fp32
    masters for training) makes every leaf require grad."""
    leaves = tree_map(lambda name, p: _cast(_leaf_init(p, generator), dtype, name), tree)
    return ParamTree(_unstack_layers(_cast(leaves, dtype)), trainable=trainable)


def cast_params(params: ParamTree, dtype: torch.dtype) -> ParamTree:
    """The same parameters with every weight cast to ``dtype`` (the
    ``keeps_fp32`` leaves stay fp32): the compute-dtype copy of fp32
    masters."""
    return ParamTree(_cast(params.to_tree(), dtype))


# ---------------------------------------------------------------------------
# Trees: parameters, gradients, optimizer moments and train states
# ---------------------------------------------------------------------------


def _children(node) -> list | None:
    """(key, child) pairs of a dict-like node in sorted-key order (the order
    in which JAX flattens a dict), or None when ``node`` is not one."""
    if isinstance(node, ParamTree):
        items = {**node._parameters, **node._modules}
    elif isinstance(node, dict):
        items = node
    else:
        return None
    return [(k, items[k]) for k in sorted(items)]


def tree_leaves(tree) -> list:
    """Every tensor of a nested ``ParamTree`` / dict / per-layer list, depth
    first in sorted-key order, layer by layer; None leaves are skipped.  Two
    trees of one structure give their leaves in the same order."""
    kids = _children(tree)
    if kids is not None:
        return [leaf for _, child in kids for leaf in tree_leaves(child)]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [] if tree is None else [tree]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure (the first a
    ``ParamTree`` or nested dict/list, the others nested dicts/lists or
    ``ParamTree``s); returns nested dicts and lists."""
    kids = _children(tree)
    if kids is not None:
        return {k: map_tree(fn, child, *(r[k] for r in rest)) for k, child in kids}
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [map_tree(fn, child, *(r[i] for r in rest)) for i, child in enumerate(tree)]
    return fn(tree, *rest)


def leaf_groups(tree, path: str = "") -> list[tuple[str, list, bool]]:
    """(path, leaves, stacked) for every leaf of a state tree, in the
    reference's flattening order and under the paths ``jax.tree_util.keystr``
    gives its twin: ``.field`` for a NamedTuple's fields, ``['key']`` for
    dict keys.  A per-layer list is one group per leaf path whose
    ``leaves`` are the layers' tensors in order (``stacked``: the reference
    holds them as one (L, ...) array); any other leaf (a tensor, an array,
    an int) is a group of one.  None leaves are skipped, as JAX skips them."""
    if hasattr(tree, "_fields"):
        return [g for f in tree._fields for g in leaf_groups(getattr(tree, f), f"{path}.{f}")]
    kids = _children(tree)
    if kids is not None:
        return [g for k, child in kids for g in leaf_groups(child, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        per_layer = [leaf_groups(child, path) for child in tree]
        return [(name, [leaf for layer in per_layer for leaf in layer[i][1]], True)
                for i, (name, _, _) in enumerate(per_layer[0])]
    return [] if tree is None else [(path, [tree], False)]


class ComputeView:
    """Fp32 master parameters as the forward reads them: each leaf cast to
    the compute dtype where it is read, as the reference casts its masters
    (``.astype(x.dtype)``) at every use.  The ``keeps_fp32`` leaves come
    back in fp32 and the embedding table as stored (it is indexed in its
    own dtype and the rows cast after, and unembedding casts it itself).
    Per-layer lists come back as lists of views.  Each read is an autograd
    cast, so gradients land on the masters in fp32.  The model code reads a
    view as it reads a ``ParamTree``: ``p["wq"]``, ``"bq" in p``, ``for
    layer in p["layers"]``."""

    __slots__ = ("_node", "_dtype")

    def __init__(self, node, dtype: torch.dtype):
        self._node, self._dtype = node, dtype

    def __getitem__(self, name: str):
        child = self._node[name]
        if isinstance(child, (ParamTree, dict)):
            return ComputeView(child, self._dtype)
        if isinstance(child, (list, nn.ModuleList)):
            return [ComputeView(c, self._dtype) for c in child]
        if name == "embed":
            return child
        return child.to(torch.float32 if keeps_fp32(name) else self._dtype)

    def __contains__(self, name: str) -> bool:
        return name in self._node


def cast_masters(params: ParamTree, dtype: torch.dtype) -> dict:
    """The reference's ``cast_params`` of a train step: every fp32 leaf of
    two or more dims cast to ``dtype`` once (an autograd cast; the rest
    kept), as nested dicts and lists."""
    return map_tree(lambda p: p.to(dtype) if p.dtype == torch.float32 and p.ndim >= 2 else p, params)


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the products without batch
    dimensions (the projections), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, policy: str) -> Callable:
    """Wrap a block fn with the config's activation-checkpoint policy, the
    twin of the reference's ``jax.checkpoint`` policies: ``"none"`` keeps
    every activation, ``"full"`` keeps only the block's inputs and
    recomputes its forward in the backward, ``"dots"`` keeps the outputs of
    the products without batch dimensions (the reference's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest.  Without
    a gradient being recorded the block runs as it is.  The recompute runs
    under the logical-axis rule context of the forward
    (``distributed.sharding.use_rules``): on the card the autograd engine
    recomputes on a thread of its own, which does not see the forward's
    thread-local context, and the MoE block would take another path there."""
    if policy == "none":
        return fn
    if policy == "full":
        kw = {}
    elif policy == "dots":
        kw = {"context_fn": functools.partial(torch_checkpoint.create_selective_checkpoint_contexts, _save_products)}
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    def block(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        from repro_torch.distributed import sharding as shd

        active = shd._active()
        if active is None:
            return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)

        def under_rules(*a):
            with shd.use_rules(*active):
                return fn(*a)

        return torch_checkpoint.checkpoint(under_rules, *args, use_reentrant=False, **kw)

    return block


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def dense(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """x @ w in the compute dtype of x, optional bias."""
    out = x @ w.to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype (span
    ``model.norm``)."""
    with span("model.norm"):
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
        return out.to(x.dtype)


def split_rms_norm(x: Tensor, gamma: Tensor, eps: float, axis: "tp.ModelAxis | None") -> Tensor:
    """``rms_norm`` over a last dim split over "model": ``x`` and ``gamma``
    are this rank's blocks, and the fp32 sum of squares is summed over the
    ranks, forward and backward (``tensor_parallel.sum_over_model``).
    Whole when ``axis`` is None."""
    if axis is None:
        return rms_norm(x, gamma, eps)
    with span("model.norm"):
        xf = x.to(torch.float32)
        var = tp.sum_over_model(torch.sum(xf * xf, dim=-1, keepdim=True), axis) / (x.shape[-1] * axis.size)
        out = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
        return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    """(head_dim/2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary position embedding (span ``model.rope``).

    Args:
      x: (..., S, H, head_dim)
      positions: (..., S) integer positions (broadcastable to x[..., :, 0, 0]).
    """
    with span("model.rope"):
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


def embed_rows(table: Tensor, tokens: Tensor, rows: int) -> Tensor:
    """``table[tokens]``.  A table of fewer than ``rows`` rows is this rank's
    vocabulary block (``distributed.tensor_parallel``): the lookup is masked
    to its rows and summed over "model" (one rank holds each token's row,
    so the sum is exact)."""
    axis = tp.split_of(table.shape[0], rows)
    if axis is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens.to(torch.int64) - axis.rank * n
    mine = (local >= 0) & (local < n)
    return tp.reduce_from_model(torch.where(mine[..., None], table[local.clamp(0, n - 1)], 0.0), axis)


def vocab_logits(h: Tensor, w: Tensor, cols: int) -> Tensor:
    """``h @ w`` for an unembedding ``w`` (d, V).  A ``w`` of fewer than
    ``cols`` columns is this rank's vocabulary block: the product gives its
    block of the logits, which the vocab-parallel CE (``_ce_sums``) reads
    as it lies."""
    axis = tp.split_of(w.shape[1], cols)
    if axis is not None:
        h = tp.copy_to_model(h, axis)
    return h @ w


def _ce_sums(logits: Tensor, labels: Tensor, vocab_size: int, z_loss: float, padded_vocab: int | None = None):
    """Masked CE partial sums: (nll_sum, z_sum, valid_count), fp32.

    Logits narrower than ``padded_vocab`` are this rank's vocabulary block
    of a vocab-parallel product (``distributed.tensor_parallel``): the max,
    the sum of exponentials and the gold logit are reduced over "model",
    the padded tail is masked at global column indices, and the z-loss
    takes the global log-sum-exp."""
    logits = logits.to(torch.float32)
    v_pad = logits.shape[-1]
    axis = tp.split_of(v_pad, padded_vocab) if padded_vocab else None
    first = 0 if axis is None else axis.rank * v_pad  # the block's first global column
    if (padded_vocab or v_pad) > vocab_size:
        logits = torch.where(first + torch.arange(v_pad, device=logits.device) < vocab_size, logits, -1e30)
    valid = labels >= 0
    labels_c = torch.clamp(labels, 0, vocab_size - 1).to(torch.int64)
    if axis is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    else:
        local = labels_c - first
        mine = (local >= 0) & (local < v_pad)
        shift = tp.max_over_model(logits.amax(dim=-1), axis)
        sumexp = tp.reduce_from_model(torch.exp(logits - shift[..., None]).sum(dim=-1), axis)
        logz = shift + torch.log(sumexp)
        gold = torch.gather(logits, -1, local.clamp(0, v_pad - 1)[..., None])[..., 0]
        gold = tp.reduce_from_model(torch.where(mine, gold, 0.0), axis)
    nll = torch.where(valid, logz - gold, 0.0)
    zl = torch.where(valid, z_loss * torch.square(logz), 0.0)
    return torch.sum(nll), torch.sum(zl), torch.sum(valid)


def _loss_metrics(nll_sum: Tensor, z_sum: Tensor, n_valid: Tensor) -> tuple[Tensor, dict]:
    denom = torch.clamp(n_valid, min=1)
    loss = (nll_sum + z_sum) / denom
    return loss, {"loss": loss, "nll": nll_sum / denom, "tokens": denom.to(torch.float32)}


def cross_entropy_loss(logits: Tensor, labels: Tensor, vocab_size: int, z_loss: float = 1e-4, *,
                       padded_vocab: int | None = None):
    """Masked softmax cross-entropy with z-loss, fp32 accumulation.

    logits (B, S, V_padded) in the compute dtype, labels (B, S) int (< 0
    ignored), ``vocab_size`` the true vocabulary: the padded tail is masked
    to -1e30, so pad entries get no probability mass whatever their
    weights.  Given the model's ``padded_vocab``, narrower logits are a
    vocab-parallel block (``_ce_sums``).  Returns (loss, {"loss", "nll",
    "tokens"}), the same numbers on every "model" rank."""
    return _loss_metrics(*_ce_sums(logits, labels, vocab_size, z_loss, padded_vocab))


def chunked_lm_loss(h: Tensor, unembed: Tensor, labels: Tensor, vocab_size: int, chunk: int,
                    z_loss: float = 1e-4, logit_softcap: float = 0.0, *, padded_vocab: int | None = None):
    """Sequence-chunked CE over final hidden states h (B, S, d) (ln_f
    applied) and the unembedding (d, V_padded): the logits are formed one
    (B, chunk, V) slice at a time, the partial sums added in the
    reference's order.  An unembedding narrower than ``padded_vocab`` is
    this rank's vocabulary block (a vocab-parallel product and CE).
    Returns what ``cross_entropy_loss`` does."""
    b, s, d = h.shape
    pad = (-s) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    axis = tp.split_of(unembed.shape[1], padded_vocab) if padded_vocab else None
    if axis is not None:
        h = tp.copy_to_model(h, axis)
    w = unembed.to(h.dtype)
    nll_sum = z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, h.shape[1], chunk):
        logits = softcap(h[:, i:i + chunk] @ w, logit_softcap)
        nll, zl, cnt = _ce_sums(logits, labels[:, i:i + chunk], vocab_size, z_loss, padded_vocab)
        nll_sum, z_sum, n_valid = nll_sum + nll, z_sum + zl, n_valid + cnt
    return _loss_metrics(nll_sum, z_sum, n_valid)
