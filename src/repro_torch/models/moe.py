"""Mixture-of-experts channel mixer (deepseek-moe fine-grained, olmoe) -- the
twin of the reference's ``repro/models/moe.py`` on one device.

Two dispatch implementations, selected by ``cfg.router_impl``:

- ``capacity`` (the default): scatter dispatch into (E, C, d) capacity
  buffers, the expert FFNs as three batched products over all E experts
  (``torch.bmm``), a gather back; entries past an expert's capacity are
  dropped in dispatch order (a stable sort ranks them);
- ``ragged``: dropless sort-based dispatch, one product per expert group --
  the FLOPs-exact oracle for drop-free comparison.  It reads the group
  sizes back to the host, so it is for comparison only; the serving path
  runs ``capacity``.

The reference's third path, explicit expert parallelism under
``shard_map`` with its int8 all-to-all (``_moe_ep``, ``_int8_all_to_all``),
needs a mesh with a "model" axis over several devices and waits for the
distributed slice (ROADMAP Queue 1 item 9.8); ``moe_apply`` here has no
such path.  The Switch-style auxiliary load-balancing loss is returned
alongside.

Counts of entries per expert are taken with ``scatter_add_`` on the device
(``torch.bincount`` reads the input's maximum back to the host on CUDA), so
the capacity path makes no host synchronisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
    dtype, aux_loss)."""
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


def _moe_capacity(p, x: Tensor, cfg: ArchConfig):
    """Capacity-buffer dispatch.  x: (T, d) -> (T, d), aux_loss."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(cfg, t)

    idx, weight, aux = _router(p, x, cfg)
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
    buf = buf[:, :cap]

    # Expert FFNs: batched products over (E, C, *).
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.cat([torch.bmm(h, p["w_down"]), x.new_zeros((e, 1, d))], dim=1)

    # Gather back and combine with the router weights.
    gathered = out_buf[safe_e, safe_c]  # (T*k, d)
    combined = (gathered.reshape(t, k, d) * weight[..., None]).sum(dim=1)
    return combined, aux


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


def moe_apply(p, x: Tensor, cfg: ArchConfig):
    """(B, S, d) -> (B, S, d), aux_loss.  Shared experts (deepseek) run
    densely on every token and add to the routed output."""
    b, s, d = x.shape
    dispatch = _moe_ragged if cfg.router_impl == "ragged" else _moe_capacity
    routed, aux = dispatch(p, x.reshape(b * s, d), cfg)
    out = routed.reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg)
    return out, aux
