"""The plain reference of the dense family: an fp32 GQA decoder with
RMSNorm, rotary positions (half rotation), grouped-query causal attention,
a SwiGLU MLP and an untied unembedding over the published vocabulary.

It follows the configuration file (``bench/configs/<name>.json``) as the
port runs it (its ``as_run`` values): the file's ``reduced`` and
``assumed`` name where that departs from the published model.  Weights come as the benchmark drew them: a dict whose
``layers`` subtree stacks each per-layer leaf along a leading axis, with
the embedding (rows) and unembedding (columns) possibly padded past the
vocabulary; ``leaf_paths`` cuts them to the vocabulary and names each
layer's leaves apart, and the model reads that.  Each layer's weights are
read in fp32 when the layer runs, so the model never holds more than one
layer in fp32 beside its inputs.

``precision="fp8"`` rounds both operands of every product, and the stored
keys and values, to float8 e4m3 with one scale a tensor (gradients too, in
training): the control that a comparison has to fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

LAYER_KEYS = ("ln1", "ln2", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "mixer.w_gate", "mixer.w_up",
              "mixer.w_down")


def strict_fp32() -> None:
    """fp32 products in full fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sizes(model: dict) -> dict:
    d, h = model["hidden_size"], model["num_attention_heads"]
    run = model["as_run"]
    return {"d": d, "layers": model["num_hidden_layers"], "heads": h, "kv_heads": model["num_key_value_heads"],
            "head_dim": model.get("head_dim", d // h), "vocab": model["vocab_size"],
            "theta": float(run["rope_theta"]), "eps": float(run["rms_norm_eps"])}


def _fp8(x: Tensor) -> Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Rounds to fp8 going forward and the incoming gradient going back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _rounder(precision: str):
    if precision == "fp32":
        return lambda x: x
    if precision == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {precision!r}")


def leaf_paths(weights: dict, model: dict) -> dict:
    """{path: tensor} of every weight, each layer's leaf apart
    (``layers.<i>.<key>``), cut to the published vocabulary (views)."""
    v = sizes(model)["vocab"]
    out = {"embed": weights["embed"][:v], "ln_f": weights["ln_f"], "unembed": weights["unembed"][:, :v]}
    for key in LAYER_KEYS:
        stacked = weights["layers"]
        for part in key.split("."):
            stacked = stacked[part]
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{key}"] = stacked[i]
    return out


def layer_weights(leaves: dict, i: int, *, grad: bool = False) -> dict:
    """Layer ``i``'s weights in fp32 (copies), as leaves that require grad
    when ``grad``."""
    return {key: leaves[f"layers.{i}.{key}"].to(torch.float32, copy=True).requires_grad_(grad)
            for key in LAYER_KEYS}


def rms_norm(x: Tensor, gain: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * gain


def rope(x: Tensor, theta: float) -> Tensor:
    """Rotary positions 0..S-1 on x (B, S, H, d): the two halves of each
    head rotated by angle position / theta ** (2i / d)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: Tensor, k: Tensor, v: Tensor, rnd) -> Tensor:
    """Causal attention of q (B, S, H, d) over k, v (B, S, Hkv, d); query
    head h reads key head h // (H / Hkv)."""
    group = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    s = q.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", rnd(q), rnd(k)) / math.sqrt(q.shape[-1])
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", rnd(p), rnd(v))


def layer(w: dict, x: Tensor, m: dict, rnd) -> tuple[Tensor, Tensor, Tensor]:
    """One pre-norm block: (output, keys after rotation, values)."""
    b, s, _ = x.shape
    hd = m["head_dim"]
    h = rms_norm(x, w["ln1"], m["eps"])
    hr = rnd(h)
    q = (hr @ rnd(w["attn.wq"])).view(b, s, m["heads"], hd)
    k = (hr @ rnd(w["attn.wk"])).view(b, s, m["kv_heads"], hd)
    v = (hr @ rnd(w["attn.wv"])).view(b, s, m["kv_heads"], hd)
    q, k = rope(q, m["theta"]), rope(k, m["theta"])
    o = attention(q, k, v, rnd).reshape(b, s, -1)
    x = x + rnd(o) @ rnd(w["attn.wo"])
    h = rnd(rms_norm(x, w["ln2"], m["eps"]))
    g = F.silu(h @ rnd(w["mixer.w_gate"])) * (h @ rnd(w["mixer.w_up"]))
    return x + rnd(g) @ rnd(w["mixer.w_down"]), k, v


def _embed(leaves: dict, tokens: Tensor) -> Tensor:
    return leaves["embed"][tokens.long()].to(torch.float32)


@torch.no_grad()
def prefill(weights: dict, tokens: Tensor, model: dict, *, precision: str = "fp32", on_layer=None) -> Tensor:
    """Causal forward over tokens (B, S): the last position's logits (B, V)
    over the published vocabulary.  ``on_layer(i, {"k": keys, "v":
    values})`` gets each layer's keys (after rotation) and values
    (B, S, Hkv, d) as they would be stored, under the names of the
    program's cache."""
    strict_fp32()
    m = sizes(model)
    rnd = _rounder(precision)
    leaves = leaf_paths(weights, model)
    x = _embed(leaves, tokens)
    for i in range(m["layers"]):
        x, k, v = layer(layer_weights(leaves, i), x, m, rnd)
        if on_layer is not None:
            on_layer(i, {"k": rnd(k), "v": rnd(v)})
    h = rms_norm(x[:, -1], leaves["ln_f"].to(torch.float32), m["eps"])
    return rnd(h) @ rnd(leaves["unembed"].to(torch.float32))


def lm_loss(logits: Tensor, labels: Tensor, z_loss: float) -> Tensor:
    """Mean over the labelled positions (label >= 0) of the softmax cross
    entropy plus ``z_loss`` times the squared log-partition."""
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    per = (logz - gold + z_loss * logz * logz) * valid
    return per.sum() / valid.sum().clamp(min=1)


def loss_and_grads(leaves: dict, tokens: Tensor, labels: Tensor, model: dict, *, z_loss: float,
                   precision: str = "fp32") -> tuple[float, dict]:
    """The LM loss of one batch and its gradient with respect to every
    weight of ``leaves`` (``leaf_paths``'s layout), as {path: fp32 tensor}.
    Layer by layer: the forward keeps each layer's input only, and the
    backward recomputes one layer at a time."""
    strict_fp32()
    m = sizes(model)
    rnd = _rounder(precision)
    n = m["layers"]
    inputs = []
    with torch.no_grad():
        x = _embed(leaves, tokens)
        for i in range(n):
            inputs.append(x)
            x = layer(layer_weights(leaves, i), x, m, rnd)[0]
    top = x.requires_grad_(True)
    ln_f = leaves["ln_f"].to(torch.float32, copy=True).requires_grad_(True)
    unembed = leaves["unembed"].to(torch.float32, copy=True).requires_grad_(True)
    logits = rnd(rms_norm(top, ln_f, m["eps"])) @ rnd(unembed)
    loss = lm_loss(logits, labels, z_loss)
    dx, g_ln, g_un = torch.autograd.grad(loss, [top, ln_f, unembed])
    del logits
    grads = {"ln_f": g_ln, "unembed": g_un}
    for i in reversed(range(n)):
        w = layer_weights(leaves, i, grad=True)
        xi = inputs[i].requires_grad_(True)
        out = layer(w, xi, m, rnd)[0]
        got = torch.autograd.grad(out, [xi, *w.values()], dx)
        dx = got[0]
        for key, g in zip(w, got[1:]):
            grads[f"layers.{i}.{key}"] = g
        inputs[i] = None
    d = m["d"]
    grads["embed"] = torch.zeros(m["vocab"], d, dtype=torch.float32, device=dx.device).index_add_(
        0, tokens.reshape(-1).long(), dx.reshape(-1, d))
    return float(loss.detach()), grads


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` of the peak."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    progress = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    decay = opt["min_lr_ratio"] + (1.0 - opt["min_lr_ratio"]) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return opt["learning_rate"] * warm * decay


def train(weights: dict, batches: list, model: dict, opt: dict, *, z_loss: float,
          precision: str = "fp32") -> dict:
    """AdamW with global-norm clipping from ``weights`` over ``batches``
    ((tokens, labels) each), in fp32.  Returns each step's loss, each
    leaf's norm of the first (clipped) gradient, and each leaf's norm of
    the parameters' change after the last step."""
    start = {k: t.to(torch.float32) for k, t in leaf_paths(weights, model).items()}
    params = {k: t.clone() for k, t in start.items()}
    mu = {k: torch.zeros_like(t) for k, t in start.items()}
    nu = {k: torch.zeros_like(t) for k, t in start.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, first = [], {}
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, tokens, labels, model, z_loss=z_loss, precision=precision)
        losses.append(loss)
        with torch.no_grad():
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
            scale = min(opt["clip_norm"] / max(norm, 1e-9), 1.0)
            lr = lr_at(step, opt)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for k, g in grads.items():
                g = g * scale
                if step == 1:
                    first[k] = float(torch.linalg.vector_norm(g))
                mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + opt["eps"])
                params[k].sub_(lr * (upd + opt["weight_decay"] * params[k]))
        del grads
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k])) for k in start}
    return {"losses": losses, "first_grad": first, "change": change}
