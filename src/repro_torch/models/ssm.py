"""The Mamba2 block (zamba2's backbone) via the chunked state-space dual
form (SSD) -- the twin of the reference's ``repro/models/ssm.py``.

Sequences are processed in chunks (``ssd_chunked``): the intra-chunk terms
are dense batched products, and the inter-chunk state recurrence is a loop
over the S/chunk chunk states (the reference's ``lax.scan``).  Both the
Mamba2 mixer (``mamba_apply``, the hybrid stack's backbone in
``models/transformer.py``) and the mLSTM matrix memory
(``models/xlstm.py``) run through it.  B/C projections are per head
((S, H, N), the multi-head SSD variant).

State carried for decode: ``h`` (B, H, P, N) fp32 and the depthwise-conv
tail (B, ssm_conv - 1, d_inner).  ``mamba_decode`` is the single-token
recurrence in fp32; it updates both in place (the reference returns new
copies).

**Split over "model"** (``distributed.tensor_parallel``), as the rules
place the block's leaves and GSPMD splits the reference's products.  Given
this rank's "model" blocks (``sharding.local_view(split=...)``, with
``models.common.BLOCK_SPLITS``), the block runs on the rank's heads: the
SSD is per head, and the conv is depthwise over ``d_inner``, whose heads
are contiguous blocks of ``ssm_head_dim`` channels, so with H / M heads a
rank the "mlp" blocks of ``conv_w``, ``conv_b``, ``gamma_gate`` and
``w_out``'s rows are exactly its heads' channels.  The fused ``w_zx`` and
``w_bc`` come regrouped to ``[z_r | xin_r]`` and ``[B_r | C_r]`` (the
rank's block of each part), so their column-parallel products give the
rank's own channels and heads; ``w_dt`` and the per-head vectors are its
heads' blocks.  The gated RMSNorm over the whole ``d_inner`` sums its
squares over "model" (``common.split_rms_norm``), and the row-parallel
``w_out`` ends in a reduce over "model".  Where the head count does not
divide the "model" size the rules replicate "heads" but may still split
``d_inner``: the rank then gathers the conv's output (and B, C when they
are split) to all heads, runs the SSD on all of them, and scatters its
output back to its channels before the norm, as attention does for heads
that do not divide.  The decode state lies where the serve rules put it:
``h`` on the rank's heads (whole when they do not divide) and the conv
tail on its channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.common import Param, split_rms_norm

Tensor = torch.Tensor


def mamba_params(cfg: ArchConfig) -> dict:
    """Parameter spec tree for one Mamba-style SSM block."""
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    return {
        "w_zx": Param((d, 2 * di), ("embed", "mlp")),
        "w_bc": Param((d, 2 * h * n), ("embed", "qkv")),
        "w_dt": Param((d, h), ("embed", "heads"), scale=0.1),
        "dt_bias": Param((h,), ("heads",), init="zeros"),
        "a_log": Param((h,), ("heads",), init="zeros"),
        "d_skip": Param((h,), ("heads",), init="ones"),
        "conv_w": Param((cfg.ssm_conv, di), ("conv", "mlp"), scale=0.5),
        "conv_b": Param((di,), ("mlp",), init="zeros"),
        "gamma_gate": Param((di,), ("mlp",), init="ones"),
        "w_out": Param((di, d), ("mlp", "embed")),
    }


def _splits(p, cfg: ArchConfig):
    """The block's split over "model", from its leaves' widths: (axis of
    the channels -- ``w_zx``, the conv, the norm, ``w_out`` --, axis of the
    heads -- ``w_dt`` and the per-head vectors --, axis of ``w_bc``), each
    None where the rank holds the whole dim."""
    cs = tp.split_of(p["w_zx"].shape[1], 2 * cfg.d_inner)
    hs = tp.split_of(p["w_dt"].shape[1], cfg.ssm_heads)
    bs = tp.split_of(p["w_bc"].shape[1], 2 * cfg.ssm_heads * cfg.ssm_state)
    if (hs is not None and (cs is None or bs is None)) or (cs is None) != (
            tp.split_of(p["w_out"].shape[0], cfg.d_inner) is None):
        raise ValueError("a Mamba2 block split on its heads needs its channels and B/C split too")
    return cs, hs, bs


def _project(p, x: Tensor, cfg: ArchConfig, split):
    """x (B,S,d) -> z, xin (B,S,di), b/c (B,S,H,N), dt (B,S,H) fp32: the
    rank's channels of z and xin and its heads of b, c and dt when the
    block is split (``_splits``); b and c of all heads when its heads do
    not divide."""
    b, s, _ = x.shape
    cs, hs, bs = split
    axis = cs or bs
    xm = x if axis is None else tp.copy_to_model(x, axis)   # the split products' input
    z, xin = torch.chunk((x if cs is None else xm) @ p["w_zx"], 2, dim=-1)
    bc = ((x if bs is None else xm) @ p["w_bc"]).reshape(b, s, 2, -1)
    if bs is not None and hs is None:
        bc = tp.gather_from_model(bc, bs, -1)
    bc = bc.reshape(b, s, 2, -1, cfg.ssm_state)
    dt = F.softplus(((x if hs is None else xm) @ p["w_dt"]).to(torch.float32) + p["dt_bias"].to(torch.float32))
    return z, xin, bc[:, :, 0], bc[:, :, 1], dt


def _heads_in(xc: Tensor, split) -> Tensor:
    """The conv's output over the heads the SSD runs on: the rank's
    channels as they are, or gathered to all heads when the heads do not
    divide."""
    cs, hs, _ = split
    return xc if cs is None or hs is not None else tp.gather_from_model(xc, cs, -1)


def _conv1d(xin: Tensor, conv_w: Tensor, conv_b: Tensor, tail: Tensor | None):
    """Causal depthwise conv over time, then SiLU.  ``tail`` (B, K-1, di) is
    the history before ``xin`` (zeros when None).  Returns (y, new_tail):
    the last K-1 inputs, history included."""
    k = conv_w.shape[0]
    if tail is None:
        tail = xin.new_zeros((xin.shape[0], k - 1, xin.shape[-1]))
    padded = torch.cat([tail, xin], dim=1)
    s = xin.shape[1]
    y = padded[:, 0:s] * conv_w[0].to(xin.dtype)   # sum_i w[i] x[t - (K-1) + i], in the reference's order
    for i in range(1, k):
        y = y + padded[:, i:i + s] * conv_w[i].to(xin.dtype)
    y = F.silu(y + conv_b.to(xin.dtype))
    return y, (padded[:, -(k - 1):] if k > 1 else tail)


def gated_down(y: Tensor, z: Tensor, gamma: Tensor, w_out: Tensor, eps: float, cs, hs) -> Tensor:
    """Gated RMSNorm of a mixer's (B, S, di) output, then the
    down-projection (the Mamba2 block's and the mLSTM's).  On the rank's
    channels (``cs``) the norm's sum of squares and the row-parallel
    product are summed over "model"; an output of all heads (``hs`` None:
    they do not divide) is scattered to the rank's channels first."""
    if cs is not None and hs is None:
        y = tp.scatter_to_model(y, cs, -1)
    out = split_rms_norm(y * F.silu(z), gamma, eps, cs) @ w_out
    return out if cs is None else tp.reduce_from_model(out, cs)


def ssd_chunked(
    xh: Tensor,       # (B, S, H, P) values
    dt: Tensor,       # (B, S, H) fp32 write strengths
    da: Tensor,       # (B, S, H) fp32 log-decays
    bmat: Tensor,     # (B, S, H, N) write keys
    cmat: Tensor,     # (B, S, H, N) read queries
    chunk: int,
    h0: Tensor | None = None,   # (B, H, P, N) initial state
):
    """Chunked SSD:  h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t.

    Shared by Mamba2 (da = dt * A) and the mLSTM matrix memory (da = log f,
    dt = the exponential input gate).  Returns (y (B,S,H,P) fp32, h_final
    (B,H,P,N) fp32).
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    s_orig = s
    if s % q:
        # Ragged tail: pad with dt = da = 0 steps -- decay exp(0) = 1 and
        # zero write strength leave the carried state exactly invariant,
        # and the padded outputs are sliced off below.
        pad = q - s % q
        xh, dt, da, bmat, cmat = (F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad)) for x in (xh, dt, da, bmat, cmat))
        s = s + pad
    nc = s // q
    x32 = xh.to(torch.float32).reshape(b, nc, q, h, p)
    b32 = bmat.to(torch.float32).reshape(b, nc, q, h, n)
    c32 = cmat.to(torch.float32).reshape(b, nc, q, h, n)
    dtc = dt.reshape(b, nc, q, h)
    cum = torch.cumsum(da.reshape(b, nc, q, h), dim=2)     # (B, nc, Q, H) inclusive

    # Intra-chunk: y[i] += sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B, nc, Qi, Qj, H)
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], li, -torch.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", c32, b32)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * decay * dtc[:, :, None], x32)

    # Chunk states: S_c = sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T  (B, nc, H, P, N)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc            # (B, nc, Q, H)
    s_chunk = torch.einsum("bcjhp,bcjhn->bchpn", x32 * w[..., None], b32)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, nc, H)

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device) if h0 is None else h0.to(torch.float32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]

    # Inter-chunk: y[i] += exp(cum_i) * H_{c-1} C_i
    y_inter = torch.einsum("bcihn,bchpn->bcihp", c32 * torch.exp(cum)[..., None], torch.stack(h_prevs, dim=1))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], state


def mamba_apply(p, x: Tensor, cfg: ArchConfig, *, state: tuple | None = None, return_state: bool = False):
    """Full-sequence Mamba2 mixer over x (B, S, d).  ``state`` = (h, conv
    tail) continues a sequence.  Returns y, or (y, (h_final, conv_tail)):
    on this rank's "model" blocks, the split program (module docstring),
    whose state is the rank's heads and channels."""
    b, s, _ = x.shape
    split = _splits(p, cfg)
    z, xin, bmat, cmat, dt = _project(p, x, cfg, split)
    h0, tail = state if state is not None else (None, None)
    xc, new_tail = _conv1d(xin, p["conv_w"], p["conv_b"], tail)
    xh = shard_activation(_heads_in(xc, split).reshape(b, s, -1, cfg.ssm_head_dim), ("batch", None, "heads", None))
    a = -torch.exp(p["a_log"].to(torch.float32))
    y, h_final = ssd_chunked(xh, dt, dt * a, bmat, cmat, cfg.ssm_chunk, h0)
    y = y + p["d_skip"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    out = gated_down(y.reshape(b, s, -1).to(x.dtype), z, p["gamma_gate"], p["w_out"], cfg.norm_eps, *split[:2])
    return (out, (h_final, new_tail)) if return_state else out


def mamba_decode(p, x: Tensor, h: Tensor, conv_tail: Tensor, cfg: ArchConfig):
    """Single-token recurrent step: x (B, 1, d); ``h`` (B, H, P, N) fp32 and
    ``conv_tail`` (B, K-1, di) are updated in place -- on this rank's
    "model" blocks, its heads' state and its channels' tail.  Returns
    (y (B,1,d), h, conv_tail)."""
    b = x.shape[0]
    split = _splits(p, cfg)
    z, xin, bmat, cmat, dt = _project(p, x, cfg, split)
    xc, new_tail = _conv1d(xin, p["conv_w"], p["conv_b"], conv_tail)
    conv_tail.copy_(new_tail)
    xh = _heads_in(xc, split).reshape(b, -1, cfg.ssm_head_dim).to(torch.float32)
    dt1 = dt[:, 0]                                               # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p["a_log"].to(torch.float32)))
    b1, c1 = bmat[:, 0].to(torch.float32), cmat[:, 0].to(torch.float32)  # (B, H, N)
    h.mul_(decay[:, :, None, None]).add_((dt1[:, :, None] * xh)[..., None] * b1[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", c1, h)
    y = y + p["d_skip"].to(torch.float32)[None, :, None] * xh
    y = gated_down(y.reshape(b, 1, -1).to(x.dtype), z, p["gamma_gate"], p["w_out"], cfg.norm_eps, *split[:2])
    return y, h, conv_tail
