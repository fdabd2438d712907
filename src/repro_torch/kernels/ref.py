"""Plain PyTorch versions of the hand-written kernels, and the int8 KV
cache's two functions.

The CPU path and the tests run the plain versions; ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.  Nothing on the
main path calls them for a CUDA tensor.  ``quantize_kv`` and
``decode_attention_quant`` are different: they have no Pallas kernel, and
the reference's models call them directly on every device
(``repro/models/attention.py``, ``transformer.py``), so the port's models
do too, on the card as well.  Each follows its twin in the reference's
``repro/kernels/ref.py``; the flash backward (``_flash_bwd``) waits for the
training slice.
"""

from __future__ import annotations

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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blocked online-softmax GQA attention, forward only.

    q (B, S, H, d), k/v (B, T, Hkv, d) -> (B, S, H, d) in q's dtype.  The
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
    q_block = max(1, min(q_block, s))
    kv_block = max(1, min(kv_block, t))
    nq, nk = -(-s // q_block), -(-t // kv_block)
    scale = 1.0 / float(d) ** 0.5
    offset = t - s
    q32 = torch.nn.functional.pad(q.to(torch.float32), (0, 0, 0, 0, 0, nq * q_block - s))
    k32 = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, 0, 0, nk * kv_block - t))
    v32 = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, nk * kv_block - t))
    qg = q32.reshape(b, nq, q_block, hkv, g, d)
    kb = k32.reshape(b, nk, kv_block, hkv, d)
    vb = v32.reshape(b, nk, kv_block, hkv, d)
    outs = []
    for qi in range(nq):
        qq = qg[:, qi]                                            # (B, qb, Hkv, G, d)
        q_pos = qi * q_block + torch.arange(q_block, device=q.device) + offset
        m = torch.full((b, hkv, g, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, q_block, d), dtype=torch.float32, device=q.device)
        hi = min((qi * q_block + q_block + offset + kv_block - 1) // kv_block, nk) if causal else nk
        for ki in range(hi):
            scores = torch.einsum("bqkgd,btkd->bkgqt", qq, kb[:, ki]) * scale
            k_pos = ki * kv_block + torch.arange(kv_block, device=q.device)
            live = (k_pos < t)[None, :]
            if causal:
                live = live & (q_pos[:, None] >= k_pos[None, :])
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
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))                   # (B, qb, Hkv, G, d)
    out = torch.cat(outs, dim=1)[:, :s]
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Single-token GQA attention against a KV cache, masked at and beyond
    each sequence's ``lengths``.

    q (B, H, d), caches (B, S, Hkv, d), lengths (B,) int -> (B, H, d) in
    q's dtype; fp32 scores and softmax.
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
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_quant(
    q: torch.Tensor,         # (B, H, d)
    k_cache: torch.Tensor,   # (B, S, Hkv, d) int8
    v_cache: torch.Tensor,   # (B, S, Hkv, d) int8
    k_scale: torch.Tensor,   # (B, S, Hkv) per-row scales
    v_scale: torch.Tensor,
    lengths: torch.Tensor,   # (B,)
) -> torch.Tensor:
    """Decode attention over an int8-quantized KV cache, masked at and
    beyond each sequence's ``lengths``: (B, H, d) in q's dtype.

    Dequantization is folded around the contractions, as the reference has
    it: scores = (q . k_q) * k_scale, out = (p * v_scale) . v_q.
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
    out = torch.einsum("bkgt,btkd->bkgd", pv, v_cache.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


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
