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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.common import Param, rms_norm

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


def _project(p, x: Tensor, cfg: ArchConfig):
    """x (B,S,d) -> z (B,S,di), xin (B,S,di), b/c (B,S,H,N), dt (B,S,H) fp32."""
    b, s, _ = x.shape
    h, n = cfg.ssm_heads, cfg.ssm_state
    z, xin = torch.chunk(x @ p["w_zx"], 2, dim=-1)
    bc = (x @ p["w_bc"]).reshape(b, s, 2, h, n)
    dt = F.softplus((x @ p["w_dt"]).to(torch.float32) + p["dt_bias"].to(torch.float32))
    return z, xin, bc[:, :, 0], bc[:, :, 1], dt


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


def _gate_out(p, y: Tensor, z: Tensor, cfg: ArchConfig) -> Tensor:
    """Gated RMSNorm of the mixer's (B, S, di) output, then the down-projection."""
    return rms_norm(y * F.silu(z), p["gamma_gate"], cfg.norm_eps) @ p["w_out"]


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
    tail) continues a sequence.  Returns y, or (y, (h_final, conv_tail))."""
    b, s, _ = x.shape
    z, xin, bmat, cmat, dt = _project(p, x, cfg)
    h0, tail = state if state is not None else (None, None)
    xc, new_tail = _conv1d(xin, p["conv_w"], p["conv_b"], tail)
    xh = shard_activation(xc.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim), ("batch", None, "heads", None))
    a = -torch.exp(p["a_log"].to(torch.float32))
    y, h_final = ssd_chunked(xh, dt, dt * a, bmat, cmat, cfg.ssm_chunk, h0)
    y = y + p["d_skip"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    out = _gate_out(p, y.reshape(b, s, cfg.d_inner).to(x.dtype), z, cfg)
    return (out, (h_final, new_tail)) if return_state else out


def mamba_decode(p, x: Tensor, h: Tensor, conv_tail: Tensor, cfg: ArchConfig):
    """Single-token recurrent step: x (B, 1, d); ``h`` (B, H, P, N) fp32 and
    ``conv_tail`` (B, K-1, di) are updated in place.  Returns (y (B,1,d), h,
    conv_tail)."""
    b = x.shape[0]
    z, xin, bmat, cmat, dt = _project(p, x, cfg)
    xc, new_tail = _conv1d(xin, p["conv_w"], p["conv_b"], conv_tail)
    conv_tail.copy_(new_tail)
    xh = xc.reshape(b, cfg.ssm_heads, cfg.ssm_head_dim).to(torch.float32)
    dt1 = dt[:, 0]                                               # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p["a_log"].to(torch.float32)))
    b1, c1 = bmat[:, 0].to(torch.float32), cmat[:, 0].to(torch.float32)  # (B, H, N)
    h.mul_(decay[:, :, None, None]).add_((dt1[:, :, None] * xh)[..., None] * b1[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", c1, h)
    y = y + p["d_skip"].to(torch.float32)[None, :, None] * xh
    return _gate_out(p, y.reshape(b, 1, cfg.d_inner).to(x.dtype), z, cfg), h, conv_tail
