"""xLSTM stack (xlstm-350m): alternating mLSTM / sLSTM blocks -- the twin of
the reference's ``repro/models/xlstm.py``.

- **mLSTM** (matrix memory, exponential gating) is gated linear attention:
  C_t = f_t C_{t-1} + i_t v_t k_t^T,  y_t = C_t q_t / max(|n_t q_t|, 1).  It
  runs through the chunked SSD form (``ssm.ssd_chunked``) with da = log f,
  dt = the exponential input gate.  The normalizer n is carried inside the
  state by augmenting the value with a constant 1 (the state is
  (P+1) x P), and the input gate's pre-activation is clipped at
  ``_IGATE_CLIP``, as the reference has it.
- **sLSTM** (scalar memory, block-diagonal recurrence) is sequential: a
  Python loop over time (the reference's ``lax.scan``) with the m_t
  max-stabilizer, one batched recurrent product per step.

Pairs are stacked under ``params["pairs"]`` (a list of {"m", "s"} trees
once loaded).  Decode updates the cache's recurrent state in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Param, rms_norm, softcap, stack_params
from repro_torch.models.ssm import ssd_chunked
from repro_torch.models.transformer import compute_dtype

Tensor = torch.Tensor

_IGATE_CLIP = 8.0  # exp-input-gate pre-activation clip (stability)


def _inv_sqrt(p: int) -> float:
    """1 / sqrt(p) rounded in fp32 at each step, as the reference takes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(p)))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_params(cfg: ArchConfig) -> dict:
    """Parameter spec tree for one mLSTM block."""
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    p = di // h
    return {
        "ln": Param((d,), (None,), init="ones"),
        "w_in": Param((d, 2 * di), ("embed", "mlp")),
        "w_qkv": Param((h, p, 3 * p), ("heads", None, None), fan_in=p),
        "w_if": Param((di, 2 * h), ("mlp", "heads"), scale=0.1),
        "b_if": Param((2 * h,), ("heads",), init="zeros"),
        "gamma": Param((di,), ("mlp",), init="ones"),
        "w_out": Param((di, d), ("mlp", "embed")),
    }


def _mlstm_gates_qkv(blk, x: Tensor, cfg: ArchConfig):
    """x (B,S,d) -> q,k,v (B,S,H,P), log_f (B,S,H), i_w (B,S,H), z (B,S,di)."""
    b, s, _ = x.shape
    hh = cfg.num_heads
    pp = 2 * cfg.d_model // hh
    xin, z = torch.chunk(x @ blk["w_in"], 2, dim=-1)
    qkv = torch.einsum("bshp,hpq->bshq", xin.reshape(b, s, hh, pp), blk["w_qkv"])
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    gates = (xin @ blk["w_if"]).to(torch.float32) + blk["b_if"].to(torch.float32)
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)          # (B,S,H) each
    log_f = -F.softplus(-f_pre)                           # log sigmoid(f_pre)
    i_w = torch.exp(torch.clamp(i_pre, -_IGATE_CLIP, _IGATE_CLIP))
    return q, k, v, log_f, i_w, z


def _mlstm_out(blk, num: Tensor, den: Tensor, z: Tensor, cfg: ArchConfig, x: Tensor) -> Tensor:
    """Normalize, gate, per-block norm, down-project."""
    b, s = num.shape[0], num.shape[1]
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    y = y.reshape(b, s, 2 * cfg.d_model).to(x.dtype)
    y = rms_norm(y * F.silu(z), blk["gamma"], cfg.norm_eps)
    return y @ blk["w_out"]


def mlstm_apply(blk, x: Tensor, cfg: ArchConfig, *, state: Tensor | None = None, return_state: bool = False):
    """Apply an mLSTM block to (B, S, d), optionally threading the
    (B, H, P+1, P) matrix memory."""
    b, s, _ = x.shape
    q, k, v, log_f, i_w, z = _mlstm_gates_qkv(blk, rms_norm(x, blk["ln"], cfg.norm_eps), cfg)
    pp = v.shape[-1]
    v_aug = torch.cat([v.to(torch.float32), v.new_ones((b, s, cfg.num_heads, 1), dtype=torch.float32)], dim=-1)
    y_aug, h_final = ssd_chunked(
        v_aug,                                           # values (P+1)
        i_w,                                             # write strengths
        log_f,                                           # log decays
        k.to(torch.float32) * _inv_sqrt(pp),             # write keys (N = P)
        q.to(torch.float32),                             # read queries
        cfg.ssm_chunk if cfg.ssm_chunk > 0 else 256,
        state,
    )
    out = x + _mlstm_out(blk, y_aug[..., :pp], y_aug[..., pp], z, cfg, x)
    return (out, h_final) if return_state else out


def mlstm_decode(blk, x: Tensor, state: Tensor, cfg: ArchConfig):
    """Single-token step: x (B,1,d); ``state`` (B,H,P+1,P) is updated in
    place.  Returns (y, state)."""
    q, k, v, log_f, i_w, z = _mlstm_gates_qkv(blk, rms_norm(x, blk["ln"], cfg.norm_eps), cfg)
    b = x.shape[0]
    pp = v.shape[-1]
    v1 = torch.cat([v[:, 0].to(torch.float32), v.new_ones((b, cfg.num_heads, 1), dtype=torch.float32)], dim=-1)
    k1 = k[:, 0].to(torch.float32) * _inv_sqrt(pp)       # (B,H,P)
    f1, i1 = torch.exp(log_f[:, 0]), i_w[:, 0]            # (B,H)
    state.mul_(f1[..., None, None]).add_(i1[..., None, None] * (v1[..., :, None] * k1[..., None, :]))
    y_aug = torch.einsum("bhn,bhpn->bhp", q[:, 0].to(torch.float32), state)  # (B,H,P+1)
    out = x + _mlstm_out(blk, y_aug[:, None, :, :pp], y_aug[:, None, :, pp], z, cfg, x)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_params(cfg: ArchConfig) -> dict:
    """Parameter spec tree for one sLSTM block."""
    d = cfg.d_model
    h = cfg.num_heads
    p = d // h
    return {
        "ln": Param((d,), (None,), init="ones"),
        "w_x": Param((d, 4 * d), ("embed", "mlp")),
        "r": Param((4, h, p, p), (None, "heads", None, None), fan_in=p, scale=0.5),
        "b": Param((4, h, p), (None, "heads", None), init="zeros"),
        "gamma": Param((d,), (None,), init="ones"),
        "w_out": Param((d, d), ("embed", "embed2")),
    }


def _recurrent(blk) -> Tensor:
    """The four gates' recurrent matrices (4, H, P, P) as one (H, P, 4P)
    operand, so a step's h_{t-1} products are one batched product."""
    r = blk["r"].to(torch.float32)
    g, h, p, _ = r.shape
    return r.permute(1, 2, 0, 3).reshape(h, p, g * p)


def _slstm_cell(r_cat: Tensor, bias: Tensor, pre_x: Tensor, carry):
    """One sLSTM time step.  pre_x: (B,4,H,P) fp32 input pre-activations;
    carry (c, n, m, h) (B,H,P) fp32 each."""
    c, n, m, h_prev = carry
    b, g, hh, p = pre_x.shape
    rec = torch.bmm(h_prev.transpose(0, 1), r_cat).reshape(hh, b, g, p).permute(1, 2, 0, 3)
    pre = pre_x + rec + bias
    i_pre, f_pre, z_pre, o_pre = pre.unbind(1)
    m_new = torch.maximum(f_pre + m, i_pre)               # exp-gating stabilizer
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new)


def _slstm_init(b: int, cfg: ArchConfig, device) -> tuple:
    hh, pp = cfg.num_heads, cfg.d_model // cfg.num_heads
    z = torch.zeros((b, hh, pp), dtype=torch.float32, device=device)
    return (z, z, torch.full((b, hh, pp), -1e30, dtype=torch.float32, device=device), z)


def _slstm_pre(blk, x: Tensor, cfg: ArchConfig) -> Tensor:
    b, s, d = x.shape
    pre = rms_norm(x, blk["ln"], cfg.norm_eps) @ blk["w_x"]
    return pre.reshape(b, s, 4, cfg.num_heads, d // cfg.num_heads).to(torch.float32)


def _slstm_out(blk, y: Tensor, cfg: ArchConfig, x: Tensor) -> Tensor:
    b, s, d = x.shape
    y = rms_norm(y.reshape(b, s, d).to(x.dtype), blk["gamma"], cfg.norm_eps)
    return x + y @ blk["w_out"]


def slstm_apply(blk, x: Tensor, cfg: ArchConfig, *, state: tuple | None = None, return_state: bool = False):
    """Apply an sLSTM block to (B, S, d), optionally threading (c, n, m, h)."""
    pre = _slstm_pre(blk, x, cfg)
    if state is None:
        state = _slstm_init(x.shape[0], cfg, x.device)
    r_cat, bias = _recurrent(blk), blk["b"].to(torch.float32)
    hs = []
    for t in range(pre.shape[1]):
        state = _slstm_cell(r_cat, bias, pre[:, t], state)
        hs.append(state[3])
    out = _slstm_out(blk, torch.stack(hs, dim=1), cfg, x)
    return (out, state) if return_state else out


def slstm_decode(blk, x: Tensor, state: tuple, cfg: ArchConfig):
    """Single-token step: x (B,1,d).  Returns (y, new state)."""
    state = _slstm_cell(_recurrent(blk), blk["b"].to(torch.float32), _slstm_pre(blk, x, cfg)[:, 0], state)
    return _slstm_out(blk, state[3], cfg, x), state


# ---------------------------------------------------------------------------
# Stack over (mLSTM, sLSTM) pairs
# ---------------------------------------------------------------------------

S_KEYS = ("s_c", "s_n", "s_m", "s_h")


def xlstm_params(cfg: ArchConfig) -> dict:
    """Parameter spec tree for the alternating mLSTM/sLSTM stack."""
    d, v = cfg.d_model, cfg.padded_vocab
    assert cfg.num_layers % 2 == 0, "xLSTM stack alternates mLSTM/sLSTM pairs"
    pair = {"m": mlstm_params(cfg), "s": slstm_params(cfg)}
    return {
        "embed": Param((v, d), ("vocab", "embed"), init="embed", scale=0.02),
        "ln_f": Param((d,), (None,), init="ones"),
        "unembed": Param((d, v), ("embed", "lm_head"), fan_in=d),
        "pairs": stack_params(pair, cfg.num_layers // 2),
    }


def _embed(params, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    return params["embed"][tokens].to(compute_dtype(cfg))


def _logits(params, h: Tensor, cfg: ArchConfig) -> Tensor:
    return softcap(rms_norm(h, params["ln_f"], cfg.norm_eps) @ params["unembed"], cfg.logit_softcap)


def xlstm_train(params, tokens: Tensor, cfg: ArchConfig):
    """Full forward (B, S) -> (logits (B, S, V_padded), aux = 0)."""
    h = _embed(params, tokens, cfg)
    for pair in params["pairs"]:
        h = slstm_apply(pair["s"], mlstm_apply(pair["m"], h, cfg), cfg)
    return _logits(params, h, cfg), torch.zeros((), dtype=torch.float32, device=h.device)


def xlstm_prefill(params, tokens: Tensor, cfg: ArchConfig):
    """Prefill: (last-position logits (B, 1, V), recurrent cache): "m"
    (L/2, B, H, P+1, P) and "s_c", "s_n", "s_m", "s_h" (L/2, B, H, P), fp32."""
    h = _embed(params, tokens, cfg)
    m_states, s_states = [], []
    for pair in params["pairs"]:
        h, m_state = mlstm_apply(pair["m"], h, cfg, return_state=True)
        h, s_state = slstm_apply(pair["s"], h, cfg, return_state=True)
        m_states.append(m_state)
        s_states.append(s_state)
    cache = {"m": torch.stack(m_states)}
    for i, name in enumerate(S_KEYS):
        cache[name] = torch.stack([st[i] for st in s_states])
    return _logits(params, h[:, -1:], cfg), cache


def xlstm_decode(params, cache: dict, token: Tensor, pos: int, cfg: ArchConfig):
    """One recurrent decode step (the position lives in the state); the
    cache's states are updated in place."""
    del pos
    h = _embed(params, token, cfg)
    for i, pair in enumerate(params["pairs"]):
        h, _ = mlstm_decode(pair["m"], h, cache["m"][i], cfg)
        h, s_state = slstm_decode(pair["s"], h, tuple(cache[n][i] for n in S_KEYS), cfg)
        for name, new in zip(S_KEYS, s_state):
            cache[name][i].copy_(new)
    return _logits(params, h, cfg), cache
