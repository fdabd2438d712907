"""The chunked state-space dual form (SSD) -- the twin of ``ssd_chunked`` in
the reference's ``repro/models/ssm.py``.

Sequences are processed in chunks: the intra-chunk terms are dense batched
products, and the inter-chunk state recurrence is a loop over the S/chunk
chunk states (the reference's ``lax.scan``).  The mLSTM matrix memory
(``models/xlstm.py``) runs through it; the Mamba2 block and the hybrid
stack that also rest on it wait for ROADMAP Queue 1 item 9.4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


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
    decay = torch.where(tri[None, None, :, :, None], torch.exp(li), 0.0)
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
