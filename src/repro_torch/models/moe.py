"""Mixture-of-experts channel mixer (deepseek-moe fine-grained, olmoe) -- the
twin of the reference's ``repro/models/moe.py``.

Three dispatch implementations, selected by ``cfg.router_impl`` and the
active rule context:

- ``ep`` (whenever ``distributed.sharding.use_rules`` is active on a mesh
  with a "model" axis, and ``router_impl != "ragged"``, exactly when the
  reference takes it): explicit expert parallelism.  Each rank routes its
  own tokens -- local to its ("pod", "data") coordinates, replicated over
  "model" -- into per-expert capacity buffers (E, C, d), one all-to-all
  over the rank's "model" group moves each expert group's buffers to its
  owner, the owner runs its ``E_loc = E / model_size`` experts, and the
  reverse all-to-all brings the results home.  Capacity is per token
  shard, ``max(ceil4(cf * t_loc * k / E), 4)``; at ``model_size == 1`` the
  all-to-alls are skipped, as the reference skips them; the aux loss is
  averaged over the whole mesh.  The reference runs this body under
  ``shard_map``; here it is per-rank code over the ``DeviceMesh``'s groups.
- ``capacity`` (the default without a rule context): scatter dispatch into
  (E, C, d) capacity buffers, the expert FFNs as three batched products
  over all E experts (``torch.bmm``), a gather back; entries past an
  expert's capacity are dropped in dispatch order (a stable sort ranks
  them);
- ``ragged``: dropless sort-based dispatch, one product per expert group --
  the FLOPs-exact oracle for drop-free comparison.  It reads the group
  sizes back to the host, so it is for comparison only; the serving path
  runs ``capacity``.

**The all-to-all.**  JAX's ``all_to_all(x, split_axis=0, concat_axis=1,
tiled=True)`` over ``ms`` ranks takes (E, C, d) to (E_loc, ms*C, d): x is
split along axis 0 into ``ms`` chunks, chunk ``j`` goes to rank ``j``,
and the chunks received are concatenated along axis 1 in source-rank
order.  ``all_to_all_single`` sends contiguous chunks of dim 0, so
``_tiled_all_to_all`` views the split axis as (ms, E_loc), moves ``ms`` to
the front, exchanges, and moves the source axis in front of the concat
axis before flattening them together; the home trip (split 1, concat 0)
is the same call with the axes swapped, which is also the exchange's
transpose.  ``moe_a2a_dtype == "int8"`` sends the buffers as rows
quantized symmetrically (``max(amax, 1e-8) / 127`` per row) with the fp32
row scales beside them, in both directions: ``_Int8AllToAll`` is the twin
of the reference's ``custom_vjp``, whose backward quantizes the cotangent
and swaps split and concat.

**Inputs of the EP path.**  ``x`` is this rank's own token block (what the
reference's ``shard_map`` hands its body) or a ``DTensor`` placed on the
rule mesh, whose local block is used and whose output comes back as a
``DTensor`` of the same placements.  Expert weights are the full (E, ...)
tensors, from which the rank takes its ``E_loc`` rows, or ``DTensor``s,
gathered to the rank's expert rows (their gradient is then a partial sum
over the token axes, sharded over "model").  Within a token shard the
"model" ranks hold the same tokens, so each expert sees every token
``model_size`` times over the ranks' copies; the expert weights' gradient
is scaled by ``1 / model_size`` so that it is the gradient of one copy
(forward values are untouched).  The "model" ranks still hold the same
tokens when the attention and the dense MLPs around the block are split
over "model" (``distributed.tensor_parallel``): those end in a reduce over
"model", so the block's input is replicated there.  deepseek's shared
experts are a dense MLP (``mlp_apply``) and run split on their "model"
blocks, which the placed step keeps (``sharding.local_view(split=...)``).

The Switch-style auxiliary load-balancing loss is returned alongside.
Counts of entries per expert are taken with ``scatter_add_`` on the device
(``torch.bincount`` reads the input's maximum back to the host on CUDA), so
the capacity path makes no host synchronisation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import Param
from repro_torch.models.mlp import mlp_apply, mlp_params

Tensor = torch.Tensor


def moe_params(cfg: ArchConfig) -> dict:
    """Parameter spec tree for the mixture-of-experts block."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    p = {
        "router": Param((d, e), ("embed", "expert"), scale=0.1),
        "w_gate": Param((e, d, f), ("expert", "embed", "expert_mlp")),
        "w_up": Param((e, d, f), ("expert", "embed", "expert_mlp")),
        "w_down": Param((e, f, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = mlp_params(cfg, d_ff=cfg.num_shared_experts * f)
    return p


def _counts(flat_idx: Tensor, e: int) -> Tensor:
    """(E,) int64 count of each expert in ``flat_idx``, on the device."""
    return torch.zeros(e, dtype=torch.int64, device=flat_idx.device).scatter_add_(
        0, flat_idx, torch.ones_like(flat_idx)
    )


def _router(p, x: Tensor, cfg: ArchConfig):
    """Top-k routing in fp32.  Returns (idx (T,k) int64, weight (T,k) in x's
    dtype, aux_loss).  The router (d, E) is read whole on every "model" rank
    where the rules put its experts on "model" (olmoe's 0.5 MiB a layer):
    the top-k needs every expert's probability, which a split product would
    gather back (ROADMAP Queue 3)."""
    t = x.shape[0]
    probs = torch.softmax(x.to(torch.float32) @ p["router"].to(torch.float32), dim=-1)
    weight, idx = torch.topk(probs, cfg.top_k, dim=-1)
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e (fraction of entries to e) * (mean prob of e).
    frac = _counts(idx.reshape(-1), cfg.num_experts).to(torch.float32) / max(t * cfg.top_k, 1)
    aux = cfg.num_experts * torch.sum(frac * probs.mean(0))
    return idx, weight.to(x.dtype), aux


def _expert_positions(flat_idx: Tensor, e: int) -> Tensor:
    """Rank of each dispatch entry within its expert, via one stable sort:
    ties are broken by dispatch order, GShard's in-order capacity
    assignment.  Returns pos (T*k,) int64."""
    n = flat_idx.shape[0]
    order = torch.argsort(flat_idx, stable=True)
    counts = _counts(flat_idx, e)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=flat_idx.device) - starts[flat_idx[order]]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def _repeat_rows(x: Tensor, k: int) -> Tensor:
    """Each row of x (T, d) k times in a row: (T*k, d), ``jnp.repeat``."""
    t, d = x.shape
    return x[:, None, :].expand(t, k, d).reshape(t * k, d)


def _capacity(cfg: ArchConfig, t: int) -> int:
    cap = int(cfg.capacity_factor * t * cfg.top_k / cfg.num_experts)
    return max(((cap + 3) // 4) * 4, 4)


def _local_dispatch(router_w, x: Tensor, cfg: ArchConfig, cap: int):
    """Route tokens x (T, d) into (E, cap, d) buffers.  Returns (buf,
    safe_e, safe_c, weight, aux): each entry's buffer slot, with the
    dropped entries pointing at the cut-off row ``cap``."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    idx, weight, aux = _router({"router": router_w}, x, cfg)
    flat_idx = idx.reshape(t * k)
    pos = _expert_positions(flat_idx, e)
    keep = pos < cap

    # Scatter into (E, C+1, d): each kept slot has one writer and every
    # dropped entry writes zeros to the cut-off row ``cap``, so a plain
    # store gives the reference's scatter-add exactly.  (An accumulating
    # ``index_put_`` sorts its indices first: on the card that sort took
    # most of an olmoe prefill's device time.)
    src = _repeat_rows(x, k)  # (T*k, d)
    safe_e = torch.where(keep, flat_idx, 0)
    safe_c = torch.where(keep, pos, cap)
    buf = x.new_zeros((e, cap + 1, d))
    buf[safe_e, safe_c] = torch.where(keep[:, None], src, 0)
    return buf[:, :cap], safe_e, safe_c, weight, aux


def _expert_ffn(buf: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    """The expert FFNs as batched products over (E, C, *)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _combine(out_buf: Tensor, safe_e: Tensor, safe_c: Tensor, weight: Tensor, t: int, k: int) -> Tensor:
    """Gather each entry's expert output back (zeros for the dropped ones)
    and combine with the router weights: (T, d)."""
    e, _, d = out_buf.shape
    out_buf = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)
    gathered = out_buf[safe_e, safe_c]  # (T*k, d)
    return (gathered.reshape(t, k, d) * weight[..., None]).sum(dim=1)


def _moe_capacity(p, x: Tensor, cfg: ArchConfig):
    """Capacity-buffer dispatch.  x: (T, d) -> (T, d), aux_loss."""
    t, _ = x.shape
    buf, safe_e, safe_c, weight, aux = _local_dispatch(p["router"], x, cfg, _capacity(cfg, t))
    buf = shd.shard_activation(buf, ("expert", "cap", None))
    out_buf = _expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    return _combine(out_buf, safe_e, safe_c, weight, t, cfg.top_k), aux


def _grouped_matmul(xs: Tensor, w: Tensor, sizes: list[int]) -> Tensor:
    """``ragged_dot``: rows of ``xs`` in expert groups of ``sizes``, each
    group times its expert's matrix of ``w`` (E, a, b)."""
    return torch.cat([g @ w[i] for i, g in enumerate(torch.split(xs, sizes)) if g.shape[0]], dim=0)


def _moe_ragged(p, x: Tensor, cfg: ArchConfig):
    """Dropless sort-based dispatch.  x: (T, d) -> (T, d), aux_loss."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    idx, weight, aux = _router(p, x, cfg)
    flat_idx = idx.reshape(t * k)
    order = torch.argsort(flat_idx, stable=True)
    xs = _repeat_rows(x, k)[order]
    sizes = _counts(flat_idx, e).tolist()  # host read: the oracle only
    h = F.silu(_grouped_matmul(xs, p["w_gate"], sizes)) * _grouped_matmul(xs, p["w_up"], sizes)
    out = torch.empty_like(xs)
    out[order] = _grouped_matmul(h, p["w_down"], sizes)
    combined = (out.reshape(t, k, d) * weight[..., None]).sum(dim=1)
    return combined, aux


# ---------------------------------------------------------------------------
# Explicit expert parallelism (per-rank code over the mesh's groups)
# ---------------------------------------------------------------------------


def _tiled_all_to_all(x: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
    """JAX's tiled ``all_to_all`` over ``group``: ``x`` split along
    ``split_axis`` into one chunk per rank, chunk ``j`` sent to rank ``j``,
    the received chunks concatenated along ``concat_axis`` in source-rank
    order."""
    ms = dist.get_world_size(group)
    send = x.unflatten(split_axis, (ms, -1)).movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    """The exact tiled all-to-all; its transpose is itself with split and
    concat swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _tiled_all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _tiled_all_to_all(g.contiguous(), group, concat_axis, split_axis), None, None, None


def _q_a2a(x: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
    """Rows (last dim) quantized to int8 with fp32 row scales, both sent
    through one tiled all-to-all each, dequantized to x's dtype."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    q = _tiled_all_to_all(q, group, split_axis, concat_axis)
    s = _tiled_all_to_all(scale.to(torch.float32), group, split_axis, concat_axis)
    return (q.to(torch.float32) * s).to(x.dtype)


class _Int8AllToAll(torch.autograd.Function):
    """All-to-all with an int8 payload in both directions (forward and
    cotangent) -- the reference's ``_int8_all_to_all`` ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _q_a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _q_a2a(g.contiguous(), group, concat_axis, split_axis), None, None, None


def _a2a(x: Tensor, group, split_axis: int, concat_axis: int, dtype: str) -> Tensor:
    fn = _Int8AllToAll if dtype == "int8" else _AllToAll
    return fn.apply(x, group, split_axis, concat_axis)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _MeshMean(torch.autograd.Function):
    """A scalar's mean over every rank of the mesh (the reference's
    ``pmean`` over the token axes and "model").  The "model" ranks of a
    token shard hold equal values, so this is the token shards' mean, and
    its gradient sums the cotangents over the token groups only (the
    "model" ranks hold equal copies of them) over the token-shard count."""

    @staticmethod
    def forward(ctx, x, mesh, token_axes):
        ctx.mesh, ctx.token_axes = mesh, token_axes
        y = x.detach().clone()
        for axis in mesh.mesh_dim_names:
            dist.all_reduce(y, group=mesh.get_group(axis))
        return y / mesh.size()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        n = 1
        for axis in ctx.token_axes:
            dist.all_reduce(g, group=ctx.mesh.get_group(axis))
            n *= ctx.mesh.size(ctx.mesh.mesh_dim_names.index(axis))
        return g / n, None, None


def _token_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _gathered(w, mesh, token_axes, keep_model_shard: bool = False) -> Tensor:
    """A ``DTensor`` weight as this rank's plain tensor for the EP body:
    whole (or, with ``keep_model_shard``, its dim-0 block on "model"), its
    gradient a partial sum over the token axes.  Plain tensors pass."""
    if not isinstance(w, DTensor):
        return w
    names = mesh.mesh_dim_names
    want = [Shard(0) if keep_model_shard and n == "model" else Replicate() for n in names]
    grad = [Partial() if n in token_axes else p for n, p in zip(names, want)]
    return w.redistribute(mesh, want).to_local(grad_placements=grad)


def _moe_ep_body(router_w, w_gate, w_up, w_down, x_loc: Tensor, cfg: ArchConfig, mesh,
                 token_axes: tuple[str, ...]):
    """One rank's EP dispatch.  x_loc (b_loc, S, d): the rank's tokens;
    w_*: its (E_loc, ...) expert blocks.  Returns (out (b_loc, S, d), aux)."""
    b, s, d = x_loc.shape
    model_size = mesh.size(mesh.mesh_dim_names.index("model"))
    t, k = b * s, cfg.top_k
    cap = _capacity(cfg, t)
    buf, safe_e, safe_c, weight, aux = _local_dispatch(router_w, x_loc.reshape(t, d), cfg, cap)
    if model_size > 1:
        group = mesh.get_group("model")
        buf = _a2a(buf, group, 0, 1, cfg.moe_a2a_dtype)  # (E, C, d) -> (E_loc, ms*C, d)
        w_gate, w_up, w_down = (_ScaleGrad.apply(w, 1.0 / model_size) for w in (w_gate, w_up, w_down))
    out_buf = _expert_ffn(buf, w_gate, w_up, w_down)
    if model_size > 1:
        out_buf = _a2a(out_buf, group, 1, 0, cfg.moe_a2a_dtype)  # home: (E_loc, ms*C, d) -> (E, C, d)
    combined = _combine(out_buf, safe_e, safe_c, weight, t, k)
    return combined.reshape(b, s, d), _MeshMean.apply(aux, mesh, token_axes)


def _moe_ep(p, x: Tensor, cfg: ArchConfig, mesh) -> tuple[Tensor, Tensor]:
    """EP dispatch on the rule mesh: local tokens, local experts."""
    token_axes = _token_axes(mesh)
    e = cfg.num_experts
    model_size = mesh.size(mesh.mesh_dim_names.index("model"))
    if e % model_size:
        raise ValueError(f"{e} experts do not split over a model axis of {model_size}")
    e_loc, m = e // model_size, mesh.get_local_rank("model")

    def local_experts(w):
        if isinstance(w, DTensor):
            return _gathered(w, mesh, token_axes, keep_model_shard=True)
        return w[m * e_loc:(m + 1) * e_loc]

    return _moe_ep_body(_gathered(p["router"], mesh, token_axes), *(local_experts(p[n]) for n in
                        ("w_gate", "w_up", "w_down")), x, cfg, mesh, token_axes)


def _ep_mesh(cfg: ArchConfig):
    """The rule context's mesh when the EP path applies, else None."""
    active = shd._active()
    if cfg.router_impl != "ragged" and active is not None and "model" in shd.mesh_axes(active[0]):
        return active[0]
    return None


def moe_apply(p, x: Tensor, cfg: ArchConfig):
    """(B, S, d) -> (B, S, d), aux_loss.  Shared experts (deepseek) run
    densely on every token and add to the routed output.

    Dispatch: the EP path whenever a rule context with a "model" axis is
    active (see the module docstring for its inputs), otherwise the
    single-shard capacity or ragged implementation."""
    mesh = _ep_mesh(cfg)
    if mesh is not None:
        token_axes = _token_axes(mesh)
        placed = None
        if isinstance(x, DTensor):  # its block on the token axes, replicated over "model"
            placed = x.redistribute(mesh, [Shard(0) if n in token_axes else Replicate() for n in mesh.mesh_dim_names])
            x = placed.to_local()
        out, aux = _moe_ep(p, x, cfg, mesh)
        if "shared" in p:
            shared = {k: _gathered(w, mesh, token_axes) for k, w in
                      ((k, p["shared"][k]) for k in ("w_gate", "w_up", "w_down") if k in p["shared"])}
            out = out + mlp_apply(shared, x, cfg, cfg.num_shared_experts * cfg.expert_d_ff)
        if placed is not None:
            out = DTensor.from_local(out, placed.device_mesh, placed.placements, run_check=False)
        return out, aux
    b, s, d = x.shape
    dispatch = _moe_ragged if cfg.router_impl == "ragged" else _moe_capacity
    routed, aux = dispatch(p, x.reshape(b * s, d), cfg)
    out = routed.reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg, cfg.num_shared_experts * cfg.expert_d_ff)
    return out, aux
