"""Plain PyTorch versions of the hand-written kernels, and the int8 KV
cache's two functions.

The CPU path and the tests run the plain versions; ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.  Nothing on the
main path calls them for a CUDA tensor.  ``quantize_kv`` and
``decode_attention_quant`` are different: they have no Pallas kernel, and
the reference's models call them directly on every device
(``repro/models/attention.py``, ``transformer.py``), so the port's models
do too, on the card as well.  Each follows its twin in the reference's
``repro/kernels/ref.py``.

``flash_bwd`` is the twin of the reference's ``_flash_bwd``, the backward
of its ``custom_vjp``, which is jnp outside any Pallas kernel.  It is the
plain version of the backward kernels (``flash_attention.flash_attention_bwd``):
``kernels.ops.flash_attention``'s autograd Function runs it for a CPU
tensor, from the (out, lse) that ``flash_fwd`` saved, and the kernels on
the card.
"""

from __future__ import annotations

import math

import torch


def disagg_gram(c: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal-equation assembly for the disaggregation solve (paper Eq. 1).

    Args:
      c: (..., N, M) contribution windows; w: (..., N) power targets.
    Returns:
      gram (..., M, M) = C^T C and rhs (..., M) = C^T W in fp32.
    """
    c32 = c.to(torch.float32)
    w32 = w.to(torch.float32)
    gram = torch.einsum("...nm,...nk->...mk", c32, c32)
    rhs = torch.einsum("...nm,...n->...m", c32, w32)
    return gram, rhs


NEG_INF = -1e30  # the reference's mask sentinel: a masked score, never NaN


def attention_dense(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, scale: float | None = None
) -> torch.Tensor:
    """Unblocked GQA attention in fp32, the score matrix materialised: the
    simplest oracle, for small shapes (no path calls it).  ``q`` (B, S, H,
    d), ``k``/``v`` (B, T, Hkv, d); causal rows end at the offset ``T - S``;
    the output takes ``q``'s dtype."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, h // hkv, d).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * scale
    if causal:
        live = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blocked online-softmax GQA attention, forward only: ``flash_fwd``'s
    output."""
    return flash_fwd(q, k, v, causal, q_block, kv_block)[0]


def _blocks(s: int, t: int, q_block: int, kv_block: int) -> tuple[int, int, int, int]:
    """Block sizes clipped to the sequence lengths and the block counts
    (ragged lengths are padded up to whole blocks)."""
    q_block = max(1, min(q_block, s))
    kv_block = max(1, min(kv_block, t))
    return q_block, kv_block, -(-s // q_block), -(-t // kv_block)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x (B, N, ...) in fp32, zero-padded along axis 1 to ``rows``."""
    x = x.to(torch.float32)
    return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2) + (0, rows - x.shape[1]))


def _live(qi: int, ki: int, q_block: int, kv_block: int, t: int, offset: int, causal: bool, device) -> torch.Tensor:
    """(qb, kvb) mask of the live (query, key) pairs of one block pair: keys
    below T and, when causal, at or before the query's position + T - S."""
    q_pos = qi * q_block + torch.arange(q_block, device=device) + offset
    k_pos = ki * kv_block + torch.arange(kv_block, device=device)
    live = (k_pos < t)[None, :]
    return live & (q_pos[:, None] >= k_pos[None, :]) if causal else live


def _kv_blocks_of(qi: int, q_block: int, kv_block: int, nk: int, offset: int, causal: bool) -> int:
    """How many kv blocks query block ``qi`` visits: all, or (causal) up to
    its last query's position."""
    return min((qi * q_block + q_block + offset + kv_block - 1) // kv_block, nk) if causal else nk


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked online-softmax GQA attention: (out, lse), the twin of the
    reference's ``_flash_fwd``.

    q (B, S, H, d), k/v (B, T, Hkv, d) -> out (B, S, H, d) in q's dtype and
    lse (B, Hkv, H // Hkv, S) fp32, each row's log-sum-exp
    ``m + log(max(l, 1e-30))`` of its scaled scores.  The
    blocked semantics of the reference's ``ref.flash_attention`` with the
    ragged handling of its Pallas wrapper: S and T are padded up to block
    multiples, padded keys are masked, the causal mask is offset by T - S,
    and kv blocks past a q block's last live key are skipped.  The running
    (max, sum, accumulator) stay fp32; rows are normalised once at the end
    with the ``max(l, 1e-30)`` floor.  A masked key's probability is 0, so a
    query row with no live key (causal, S > T, rows before S - T) gives 0,
    as both CUDA kernels do.  The reference's blocked versions give such a
    row the mean of V over the key slots of the kv blocks they visit, which
    depends on their block sizes; every other row is the same either way.
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q_block, kv_block, nq, nk = _blocks(s, t, q_block, kv_block)
    scale = 1.0 / float(d) ** 0.5
    offset = t - s
    qg = _pad_rows(q, nq * q_block).reshape(b, nq, q_block, hkv, g, d)
    kb = _pad_rows(k, nk * kv_block).reshape(b, nk, kv_block, hkv, d)
    vb = _pad_rows(v, nk * kv_block).reshape(b, nk, kv_block, hkv, d)
    outs, lses = [], []
    for qi in range(nq):
        qq = qg[:, qi]                                            # (B, qb, Hkv, G, d)
        m = torch.full((b, hkv, g, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, q_block, d), dtype=torch.float32, device=q.device)
        for ki in range(_kv_blocks_of(qi, q_block, kv_block, nk, offset, causal)):
            scores = torch.einsum("bqkgd,btkd->bkgqt", qq, kb[:, ki]) * scale
            live = _live(qi, ki, q_block, kv_block, t, offset, causal, q.device)
            scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
            m_new = torch.maximum(m, scores.amax(dim=-1))
            # A row with no live key yet still has the sentinel max: taken
            # against 0 instead, its masked scores get probability 0.
            m_exp = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
            p = torch.exp(scores - m_exp[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vb[:, ki])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        lses.append(m + torch.log(l))
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))  # (B, qb, Hkv, G, d)
    out = torch.cat(outs, dim=1)[:, :s]
    return out.reshape(b, s, h, d).to(q.dtype), torch.cat(lses, dim=-1)[..., :s]


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recomputing FlashAttention backward: (dq, dk, dv) in the inputs'
    dtypes, the twin of the reference's ``_flash_bwd``.

    ``out`` and ``lse`` are the forward's (``flash_fwd``, or the CUDA
    kernel's with its lse store).  Per (q block, kv block) pair the masked,
    normalised probabilities are recomputed as exp(s - lse), then dS = P
    (dO V^T - rowsum(dO * O)), dQ += dS K * scale, dK += dS^T Q * scale and
    dV += P^T dO, all in fp32.  The reference visits every live block pair
    twice (once in a loop over q blocks for dQ, once over kv blocks for dK
    and dV); here one pass over the kv blocks, each over the q blocks that
    reach it, feeds all three, and every accumulator still sums its blocks
    in the reference's order (dQ over ascending kv blocks, dK and dV over
    ascending q blocks): the same sums at half the products.  Dead pairs
    get probability 0 from the mask itself, not from exp(-1e30 - lse), so
    a row with no live key (lse -1e30, output 0) gets zero gradient.
    Ragged S and T are zero-padded to whole blocks, as in ``flash_fwd``.
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q_block, kv_block, nq, nk = _blocks(s, t, q_block, kv_block)
    scale = 1.0 / float(d) ** 0.5
    offset = t - s
    qg = _pad_rows(q, nq * q_block).reshape(b, nq, q_block, hkv, g, d)
    dog = _pad_rows(dout, nq * q_block).reshape(b, nq, q_block, hkv, g, d)
    og = _pad_rows(out, nq * q_block).reshape(b, nq, q_block, hkv, g, d)
    lseg = torch.nn.functional.pad(lse.to(torch.float32), (0, nq * q_block - s)).reshape(b, hkv, g, nq, q_block)
    kb = _pad_rows(k, nk * kv_block).reshape(b, nk, kv_block, hkv, d)
    vb = _pad_rows(v, nk * kv_block).reshape(b, nk, kv_block, hkv, d)
    dsum = (dog * og).sum(dim=-1).permute(0, 1, 3, 4, 2)          # rowsum(dO * O): (B, nq, Hkv, G, qb)
    dq = [torch.zeros((b, q_block, hkv, g, d), dtype=torch.float32, device=q.device) for _ in range(nq)]
    dks, dvs = [], []
    for ki in range(nk):
        kk, vv = kb[:, ki], vb[:, ki]
        dk = torch.zeros((b, kv_block, hkv, d), dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for qi in range(max((ki * kv_block - offset) // q_block, 0) if causal else 0, nq):
            live = _live(qi, ki, q_block, kv_block, t, offset, causal, q.device)
            scores = torch.einsum("bqkgd,btkd->bkgqt", qg[:, qi], kk) * scale
            p = torch.where(live, torch.exp(scores - lseg[:, :, :, qi][..., None]), 0.0)  # (B, Hkv, G, qb, kvb)
            dp = torch.einsum("bqkgd,btkd->bkgqt", dog[:, qi], vv)
            ds = p * (dp - dsum[:, qi][..., None])
            dq[qi] = dq[qi] + torch.einsum("bkgqt,btkd->bqkgd", ds, kk) * scale
            dk = dk + torch.einsum("bkgqt,bqkgd->btkd", ds, qg[:, qi]) * scale
            dv = dv + torch.einsum("bkgqt,bqkgd->btkd", p, dog[:, qi])
        dks.append(dk)
        dvs.append(dv)
    dq = torch.cat(dq, dim=1)[:, :s].reshape(b, s, h, d).to(q.dtype)
    return dq, torch.cat(dks, dim=1)[:, :t].to(k.dtype), torch.cat(dvs, dim=1)[:, :t].to(v.dtype)

def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor, *,
    return_lse: bool = False,
):
    """Single-token GQA attention against a KV cache, masked at and beyond
    each sequence's ``lengths``.

    q (B, H, d), caches (B, S, Hkv, d), lengths (B,) int -> (B, H, d) in
    q's dtype; fp32 scores and softmax.  With ``return_lse``, (out, lse):
    lse (B, H) fp32, each row's natural log-sum-exp of its scaled scores
    over the live keys, -inf at length 0, as the kernel's store gives it.
    """
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = 1.0 / float(d) ** 0.5
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(torch.float32)) * scale
    mask = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h)
    return out, torch.where(lengths.to(q.device)[:, None] > 0, lse, torch.full_like(lse, float("-inf")))


def decode_attention_quant(
    q: torch.Tensor,         # (B, H, d)
    k_cache: torch.Tensor,   # (B, S, Hkv, d) int8
    v_cache: torch.Tensor,   # (B, S, Hkv, d) int8
    k_scale: torch.Tensor,   # (B, S, Hkv) per-row scales
    v_scale: torch.Tensor,
    lengths: torch.Tensor,   # (B,)
    *,
    return_lse: bool = False,
):
    """Decode attention over an int8-quantized KV cache, masked at and
    beyond each sequence's ``lengths``: (B, H, d) in q's dtype.

    Dequantization is folded around the contractions, as the reference has
    it: scores = (q . k_q) * k_scale, out = (p * v_scale) . v_q.  With
    ``return_lse``, (out, lse) as ``decode_attention`` gives them: a block
    of a cache split on kv_seq, for ``models.attention.merge_partials``.
    """
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = 1.0 / float(d) ** 0.5
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(torch.float32))
    scores = scores * k_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, :] * scale
    mask = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    pv = p * v_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgt,btkd->bkgd", pv, v_cache.to(torch.float32)).reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h)
    return out, torch.where(lengths.to(q.device)[:, None] > 0, lse, torch.full_like(lse, float("-inf")))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) symmetric int8 quantization of K or V rows.

    x (..., d) -> (int8 of the same shape, bf16 scales (...)).  The int8
    values are rounded (half to even, as ``jnp.round``) with the fp32
    scale; the scale is cast to bf16 after, in the reference's order.
    """
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis, fp32
    statistics, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)).to(x.dtype)
