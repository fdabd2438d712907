"""Architecture configuration schema.

One ``ArchConfig`` covers all six assigned families (dense GQA, MoE, Mamba2
hybrid, xLSTM, encoder-decoder, VLM); family-specific fields are zero/empty
when unused.  Every assigned architecture has a module in ``repro_torch.configs``
exposing ``CONFIG`` (the exact published dims) and ``REDUCED`` (a same-family
smoke config small enough for a CPU forward/train step).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- attention / MLP options
    qkv_bias: bool = False      # qwen2.5: bias on QKV projections
    mlp: str = "swiglu"         # swiglu | sq_relu
    rope_theta: float = 1.0e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE (deepseek-moe, olmoe)
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0        # fine-grained expert width
    first_dense: bool = False   # deepseek-moe: layer 0 is a dense FFN
    capacity_factor: float = 1.25
    router_impl: str = "capacity"   # capacity | ragged (dropless)
    moe_a2a_dtype: str = "bf16"     # bf16 | int8 (quantized EP dispatch)
    kv_cache_dtype: str = "bf16"    # bf16 | int8 (quantized decode KV cache)
    ce_chunk: int = 0               # >0: sequence-chunked CE (never builds full logits)

    # --- SSM / hybrid (zamba2) and Mamba2 params
    ssm_state: int = 0          # N
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0         # hybrid: shared attention block every k layers

    # --- xLSTM
    slstm_every: int = 0        # 0 = no sLSTM blocks; 2 = alternate m/s

    # --- encoder-decoder (seamless)
    encoder_layers: int = 0

    # --- modality frontend stubs (vlm/audio): precomputed embeddings
    frontend_tokens: int = 0    # patches/frames prepended or encoded
    frontend_dim: int = 0       # embedding dim delivered by the stub

    # --- numerics / scale
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 2048  # pad vocab so ("vocab" % model_axis == 0)
    remat: str = "full"             # none | full | dots  (activation ckpt policy)
    logit_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def decoder_layers(self) -> int:
        return self.num_layers

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D roofline bookkeeping)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d * (1 if self.tie_embeddings else 2)  # embed + unembed
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            if self.family == "moe":
                e_ff = self.expert_d_ff
                routed = self.num_experts * (3 * d * e_ff)
                shared = self.num_shared_experts * (3 * d * e_ff)
                router = d * self.num_experts
                mlp = routed + shared + router
            else:
                nmat = 3 if self.mlp == "swiglu" else 2
                mlp = nmat * d * self.d_ff
            per_layer = attn + mlp + 2 * d
            n += self.num_layers * per_layer
            if self.family == "encdec":
                cross = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                nmat = 3 if self.mlp == "swiglu" else 2
                n += self.encoder_layers * (attn + nmat * d * self.d_ff + 2 * d)
                n += self.num_layers * cross  # decoder cross-attention
        elif self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * self.ssm_heads * ns) + di * d + di
            n += self.num_layers * (mamba + 2 * d)
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            nmat = 3 if self.mlp == "swiglu" else 2
            n += attn + nmat * d * max(self.d_ff, 1)  # one shared block
        elif self.family == "ssm":  # xLSTM
            di = 2 * d
            per = d * 2 * di + di * d + 3 * di * di // max(self.num_heads, 1)
            n += self.num_layers * per
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        e_ff = self.expert_d_ff
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        active_mlp = (self.num_shared_experts + self.top_k) * (3 * d * e_ff)
        n = self.padded_vocab * d * 2
        n += self.num_layers * (attn + active_mlp + d * self.num_experts + 2 * d)
        return n
