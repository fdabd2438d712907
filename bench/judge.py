"""The comparison that decides ``correct``: the numbers each kind of cell
compares with the plain reference of its family (``ref``, a module of
``bench/reference/``), and the limits they are held to
(``bench/limits/<cell>.json``)."""

from __future__ import annotations

import math
import statistics

import torch


def _rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over the leading axis, of ||got - want|| / ||want||."""
    got = got.reshape(got.shape[0], -1).to(torch.float32)
    want = want.reshape(want.shape[0], -1).to(torch.float32)
    err = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1).clamp(min=1e-30)
    return float(err.max())


def score_numbers(ref, weights: dict, model: dict, outputs: list) -> dict:
    """``logits_err``: the worst relative L2 gap, over the prompts of the
    compared invocations, between a prompt's last-position logits (over the
    published vocabulary) and the reference's.  ``cache_err``: the worst
    such gap of any cache entry one layer wrote for one prompt (for a dense
    model, its keys or values), against the rows the reference hands
    ``on_layer`` under the entry's name.

    ``outputs`` holds (tokens (B, S), logits (B, 1, V'), cache: {name:
    (L, B, ...)}) for each compared invocation."""
    vocab = model["vocab_size"]
    logits_err = cache_err = 0.0
    for tokens, logits, cache in outputs:
        def on_layer(i, rows, cache=cache):
            nonlocal cache_err
            cache_err = max([cache_err] + [_rel_rows(cache[name][i], t) for name, t in rows.items()])

        want = ref.prefill(weights, tokens, model, on_layer=on_layer)
        logits_err = max(logits_err, _rel_rows(logits[:, -1, :vocab], want))
    return {"logits_err": logits_err, "cache_err": cache_err}


def reference_outputs(ref, weights: dict, model: dict, tokens: torch.Tensor, precision: str) -> tuple:
    """(logits (B, 1, V), cache) of the reference run in ``precision``, in
    the program's output layout: what the control puts in its place."""
    layers: list = []
    logits = ref.prefill(weights, tokens, model, precision=precision, on_layer=lambda i, rows: layers.append(rows))
    return logits[:, None], {name: torch.stack([rows[name] for rows in layers]) for name in layers[0]}


def _leaf_gap(got: dict, want: dict, keys, floor: float) -> float:
    return max(abs(got[k] - want[k]) / max(want[k], floor) for k in keys)


def train_numbers(program: dict, reference: dict) -> dict:
    """``loss_err``: the worst relative gap of a step's loss.  ``grad_err``:
    the worst leaf's gap between the program's and the reference's norms of
    the first (clipped) gradient, against the larger of the reference's
    norm of that leaf and of the median leaf.  ``change_err``: the same for
    the norm of the parameters' change over the compared steps, over the
    leaves whose first gradient in the reference is at least a thousandth
    of the median leaf's (the others move by round-off under Adam).

    Each side is {"losses": [...], "first_grad": {path: norm},
    "change": {path: norm}}."""
    loss_err = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"], strict=True))
    grads = reference["first_grad"]
    if set(program["first_grad"]) != set(grads) or set(program["change"]) != set(reference["change"]):
        raise ValueError("the program's and the reference's leaves differ")
    med = statistics.median(grads.values())
    moving = [k for k, g in grads.items() if g >= 1e-3 * med]
    med_change = statistics.median(reference["change"][k] for k in moving)
    return {
        "loss_err": loss_err,
        "grad_err": _leaf_gap(program["first_grad"], grads, grads, med),
        "change_err": _leaf_gap(program["change"], reference["change"], moving, med_change),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): correct when every number is
    finite and at most its limit; a number with no limit fails."""
    checks = [(name, value, limits.get(name)) for name, value in numbers.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks
