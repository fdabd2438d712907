"""Analytic per-step cost model: FLOPs and HBM bytes -- the twin of the
reference's ``repro/launch/costs.py``, term for term.

Why analytic: the reference found that XLA's ``cost_analysis()`` counts a
while-loop body once, so a scan over layers under-reports by about the
layer count; its roofline uses this model for the compute and memory
terms.  The port keeps the same model so that both packages state the same
cost for a cell.  Its tests check it two ways: dense forward FLOPs within
the 2*N*D convention, and ``torch.utils.flop_counter.FlopCounterMode`` on a
small loop-free model (the twin of the reference's ``cost_analysis``
check).  ``chip_smoke.py`` prints the training cell's step cost beside its
measured step time.

All quantities are GLOBAL per step; roofline terms divide by (chips x
per-chip peak).  T below = tokens processed by the step.  Imports only the
configs.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig

FP32 = 4
BF16 = 2


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops: float              # global FLOPs per step
    hbm_bytes: float          # global HBM traffic per step
    details: dict

    def per_device(self, n: int) -> "StepCost":
        return StepCost(self.flops / n, self.hbm_bytes / n, self.details)


# ---------------------------------------------------------------------------
# Forward FLOPs per family (per token unless noted)
# ---------------------------------------------------------------------------


def _attn_proj_flops(cfg: ArchConfig) -> float:
    """QKV + output projections, per token."""
    d = cfg.d_model
    return 2.0 * d * (cfg.q_dim + 2 * cfg.kv_dim) + 2.0 * cfg.q_dim * d


def _attn_score_flops(cfg: ArchConfig, t_q: float, kv_len: float, causal: bool) -> float:
    """Score + PV contractions, TOTAL over t_q query tokens."""
    factor = 0.5 if causal else 1.0  # causal averages kv_len/2 per query
    return 2.0 * 2.0 * t_q * kv_len * factor * cfg.q_dim


def _mlp_flops(cfg: ArchConfig, d_ff: int | None = None) -> float:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    nmat = 3 if cfg.mlp == "swiglu" else 2
    return 2.0 * nmat * d * f


def _moe_flops(cfg: ArchConfig) -> float:
    """Router + shared + active routed experts, per token."""
    d = cfg.d_model
    router = 2.0 * d * cfg.num_experts
    active = 2.0 * 3 * d * cfg.expert_d_ff * (cfg.top_k + cfg.num_shared_experts)
    # Capacity slack: buffers are sized capacity_factor x the mean load, and
    # the dense expert einsums run over full buffers (empty slots included).
    return router + active * cfg.capacity_factor


def _mamba_flops(cfg: ArchConfig) -> float:
    """Mamba2 block, per token (projections + chunked SSD)."""
    d, di = cfg.d_model, cfg.d_inner
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = cfg.ssm_chunk
    proj = 2.0 * d * (2 * di + 2 * h * n + h) + 2.0 * di * d
    conv = 2.0 * cfg.ssm_conv * di
    # SSD per token: intra-chunk scores (q x q per chunk -> q per token) over
    # heads x state, weighted sum over head_dim, plus state build/read.
    intra = 2.0 * q * h * n + 2.0 * q * h * p
    state = 2.0 * 2.0 * h * p * n
    return proj + conv + intra + state


def _mlstm_flops(cfg: ArchConfig) -> float:
    d = cfg.d_model
    di = 2 * d
    h = cfg.num_heads
    p = di // h
    q = cfg.ssm_chunk if cfg.ssm_chunk > 0 else 256
    proj = 2.0 * d * 2 * di + 2.0 * h * p * 3 * p + 2.0 * di * 2 * h + 2.0 * di * d
    intra = 2.0 * q * h * p + 2.0 * q * h * (p + 1)
    state = 2.0 * 2.0 * h * (p + 1) * p
    return proj + intra + state


def _slstm_flops(cfg: ArchConfig) -> float:
    d = cfg.d_model
    h = cfg.num_heads
    p = d // h
    return 2.0 * d * 4 * d + 2.0 * 4 * h * p * p + 2.0 * d * d


def forward_flops(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Global forward-pass FLOPs, itemized."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        t_q = float(b)           # one new token per sequence
        kv_len = float(s)
        causal = False           # one query over the full cache
    else:
        t_q = float(b) * s
        kv_len = float(s)
        causal = True

    d, v = cfg.d_model, cfg.padded_vocab
    items: dict[str, float] = {}
    items["embed_logits"] = 2.0 * t_q * d * v  # unembed matmul (gather ~free)

    fam = cfg.family
    if fam in ("dense", "vlm"):
        per_tok = _attn_proj_flops(cfg) + _mlp_flops(cfg)
        items["blocks"] = cfg.num_layers * per_tok * t_q
        items["attention"] = cfg.num_layers * _attn_score_flops(cfg, t_q, kv_len, causal)
        if fam == "vlm":
            items["frontend"] = 2.0 * cfg.frontend_dim * d * float(b) * cfg.frontend_tokens
    elif fam == "moe":
        n_moe = cfg.num_layers - (1 if cfg.first_dense else 0)
        per_tok = _attn_proj_flops(cfg)
        items["blocks"] = cfg.num_layers * per_tok * t_q
        items["attention"] = cfg.num_layers * _attn_score_flops(cfg, t_q, kv_len, causal)
        items["moe"] = n_moe * _moe_flops(cfg) * t_q
        if cfg.first_dense:
            items["dense0"] = _mlp_flops(cfg) * t_q
    elif fam == "hybrid":
        napp = (cfg.num_layers + cfg.attn_every - 1) // max(cfg.attn_every, 1)
        items["mamba"] = cfg.num_layers * _mamba_flops(cfg) * t_q
        items["shared_attn"] = napp * (
            (_attn_proj_flops(cfg) + _mlp_flops(cfg)) * t_q
            + _attn_score_flops(cfg, t_q, kv_len, causal)
        )
    elif fam == "ssm":  # xLSTM
        pairs = cfg.num_layers // 2
        items["mlstm"] = pairs * _mlstm_flops(cfg) * t_q
        items["slstm"] = pairs * _slstm_flops(cfg) * t_q
    elif fam == "encdec":
        src = float(b) * (s if shape.kind != "decode" else min(s, 4096))
        enc_per_tok = _attn_proj_flops(cfg) + _mlp_flops(cfg)
        if shape.kind == "decode":
            items["encoder"] = 0.0  # memory precomputed at prefill
        else:
            # encoder self-attention: each of the src tokens attends over its
            # own sequence's src/b positions (non-causal).
            items["encoder"] = cfg.encoder_layers * (
                enc_per_tok * src + 2.0 * 2.0 * src * (src / b) * cfg.q_dim
            )
        dec_per_tok = _attn_proj_flops(cfg) * 2 + _mlp_flops(cfg)  # self + cross proj
        items["decoder"] = cfg.num_layers * dec_per_tok * t_q
        items["self_attn"] = cfg.num_layers * _attn_score_flops(cfg, t_q, kv_len, causal)
        cross_len = (s if shape.kind != "decode" else min(s, 4096))
        items["cross_attn"] = cfg.num_layers * _attn_score_flops(cfg, t_q, cross_len, False)
    else:
        raise ValueError(fam)
    items["total"] = sum(v for k, v in items.items() if k != "total")
    return items


_REMAT_EXTRA = {"none": 0.0, "dots": 0.5, "full": 1.0}


def step_cost(cfg: ArchConfig, shape: ShapeConfig, *, accum_steps: int = 1) -> StepCost:
    """Global per-step FLOPs + HBM bytes for the cell's step kind."""
    fwd = forward_flops(cfg, shape)
    n_params = cfg.param_count()
    b, s = shape.global_batch, shape.seq_len
    t_q = float(b) * (1 if shape.kind == "decode" else s)

    if shape.kind == "train":
        mult = 3.0 + _REMAT_EXTRA.get(cfg.remat, 1.0)
        flops = fwd["total"] * mult
        # weights: fwd read + bwd read (+ remat read) in bf16-compute fp32
        # master; grads + adam moments read/write in fp32.
        w_bytes = n_params * (FP32 * 2 + FP32 * 2 + FP32 * 4 * 2 + FP32 * 2)
        act_bytes = t_q * cfg.d_model * BF16 * cfg.num_layers * 4.0 * (1.0 / accum_steps + 1.0)
        logits_bytes = t_q * cfg.padded_vocab * FP32 * 2 / accum_steps
        hbm = w_bytes + act_bytes * accum_steps + logits_bytes * accum_steps
    elif shape.kind == "prefill":
        flops = fwd["total"]
        w_bytes = n_params * BF16
        act_bytes = t_q * cfg.d_model * BF16 * cfg.num_layers * 4.0
        kv_bytes = t_q * cfg.kv_dim * BF16 * 2 * cfg.num_layers
        hbm = w_bytes + act_bytes + kv_bytes
    else:  # decode
        flops = fwd["total"]
        w_bytes = n_params * BF16
        kv_el = 1 + 2.0 / cfg.head_dim if cfg.kv_cache_dtype == "int8" else BF16
        kv_read = float(b) * s * cfg.kv_dim * kv_el * 2 * _kv_layers(cfg)
        state_bytes = _state_bytes(cfg, b)
        hbm = w_bytes + kv_read + state_bytes
    return StepCost(flops=flops, hbm_bytes=hbm, details=fwd)


def _kv_layers(cfg: ArchConfig) -> int:
    """Layers holding a dense KV cache."""
    if cfg.family == "hybrid":
        return (cfg.num_layers + cfg.attn_every - 1) // max(cfg.attn_every, 1)
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return 2 * cfg.num_layers  # self + cross
    return cfg.num_layers


def _state_bytes(cfg: ArchConfig, b: int) -> float:
    if cfg.family == "hybrid":
        per_layer = b * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * FP32
                         + (cfg.ssm_conv - 1) * cfg.d_inner * BF16)
        return 2.0 * cfg.num_layers * per_layer  # read + write
    if cfg.family == "ssm":
        di = 2 * cfg.d_model
        h = cfg.num_heads
        p = di // h
        pairs = cfg.num_layers // 2
        m_state = b * h * (p + 1) * p * FP32
        s_state = 4 * b * cfg.d_model * FP32
        return 2.0 * pairs * (m_state + s_state)
    return 0.0
