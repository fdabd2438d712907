"""The dense GQA decoder family: RMSNorm, rotary positions, grouped-query
causal attention, a SwiGLU MLP, an untied unembedding (the port's
``family="dense"``).  Its plain reference is ``bench/reference/dense.py``.

What the harness needs of a family, found by the configuration file's
``family`` key: the fields the port's configuration must have
(``port_fields``), the layout of the weights (``expected_shapes``, ``std``,
``published``), and the work of its parts (``product_weights``,
``unembed_weights``, ``attention_flops``), from which each driver counts
one unit's model FLOPs.  The counts are frozen here with the benchmark:
the per-token counts of the projections and of the SwiGLU MLP, and the
causal convention of the attention scores, are those of the port's
``launch/costs.py``.
"""

from __future__ import annotations

from bench import costs

#: std of the embedding rows; every other matrix draws N(0, 1 / fan_in).
EMBED_STD = 0.02


def dims(model: dict) -> dict:
    """The sizes of a configuration file, under short names."""
    d = model["hidden_size"]
    h = model["num_attention_heads"]
    return {
        "d": d, "layers": model["num_hidden_layers"], "heads": h, "kv_heads": model["num_key_value_heads"],
        "head_dim": model.get("head_dim", d // h), "ff": model["intermediate_size"], "vocab": model["vocab_size"],
    }


def port_fields(model: dict) -> dict:
    """The port's ``ArchConfig`` fields, as this family and the file's
    sizes and ``as_run`` values fix them.  The family scales embeddings,
    residual branches and logits by 1 and attention scores by
    1 / sqrt(head_dim); an ``as_run`` that states other multipliers is
    refused."""
    m, run = dims(model), model["as_run"]
    plain = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0, "logits_scaling": 1.0,
             "attention_multiplier": m["head_dim"] ** -0.5}
    other = {k: run[k] for k, v in plain.items() if k in run and run[k] != v}
    if other:
        raise ValueError(f"the dense family models no multipliers; {model['name']}.json runs {other}")
    return {
        "family": "dense", "d_model": m["d"], "num_layers": m["layers"], "num_heads": m["heads"],
        "num_kv_heads": m["kv_heads"], "head_dim": m["head_dim"], "d_ff": m["ff"], "vocab_size": m["vocab"],
        "mlp": "swiglu", "rope_theta": run["rope_theta"], "norm_eps": run["rms_norm_eps"],
        "tie_embeddings": run["tie_word_embeddings"], "qkv_bias": False, "logit_softcap": 0.0,
        "kv_cache_dtype": "bf16", "compute_dtype": run["compute_dtype"],
    }


def expected_shapes(model: dict, padded_vocab: int) -> dict:
    """Each leaf's shape in the port's input layout (per-layer leaves
    stacked along a leading axis; the vocabulary padded as the port pads
    it)."""
    m = dims(model)
    d, n, q, kv, f = m["d"], m["layers"], m["heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"], m["ff"]
    return {
        "embed": (padded_vocab, d), "ln_f": (d,), "unembed": (d, padded_vocab),
        "layers.ln1": (n, d), "layers.ln2": (n, d),
        "layers.attn.wq": (n, d, q), "layers.attn.wk": (n, d, kv), "layers.attn.wv": (n, d, kv),
        "layers.attn.wo": (n, q, d), "layers.mixer.w_gate": (n, d, f), "layers.mixer.w_up": (n, d, f),
        "layers.mixer.w_down": (n, f, d),
    }


def std(path: str, shape: tuple) -> float | None:
    """The std a leaf is drawn with; None for a norm gain, which is ones."""
    leaf = path.split(".")[-1]
    if leaf.startswith("ln"):
        return None
    return EMBED_STD if leaf == "embed" else shape[-2] ** -0.5


def published(path: str, t, vocab: int):
    """A leaf of the port's layout cut to the published vocabulary."""
    if path == "embed":
        return t[:vocab]
    if path == "unembed":
        return t[:, :vocab]
    return t


def product_weights(model: dict) -> int:
    """Weights a token meets in the decoder layers' products: Q, K, V, O
    and the three SwiGLU matrices of every layer."""
    m = dims(model)
    q, kv = m["heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"]
    return m["layers"] * (m["d"] * (q + 2 * kv) + q * m["d"] + 3 * m["d"] * m["ff"])


def unembed_weights(model: dict) -> int:
    """Weights of the unembedding over the published vocabulary."""
    m = dims(model)
    return m["d"] * m["vocab"]


def attention_flops(model: dict, batch: int, queries: int, keys: int, causal: bool) -> float:
    """Score and value products of every layer."""
    m = dims(model)
    return m["layers"] * costs.attention_flops(batch, queries, keys, m["heads"], m["head_dim"], causal)
