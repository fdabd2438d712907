"""The port's host spans (``repro_torch.spans``) under a CPU
``torch.profiler`` trace, on the reduced internlm2 config.

- ``ServeEngine``'s calls each open their ``serve.*`` span around the
  model's work and the synchronise's ``serve.sync``; a prefill holds one
  ``model.embed``, ``model.cache`` and ``model.unembed``, a
  ``model.attention`` and a ``model.mlp`` for each layer, a ``model.rope``
  for each of q and k and a ``model.norm`` for each pre-norm and the final
  norm;
- the operators of ``rms_norm``, ``split_rms_norm``, ``apply_rope``,
  ``attention_apply`` and ``mlp_apply`` all run under their span;
- a train step's ``train.forward``, ``train.backward`` and
  ``train.optimizer`` follow each other, AdamW's ``aten::sqrt`` (one for
  each leaf) under the last, the recomputation of remat "full" under the
  backward;
- every span the package opens is named by a literal, dotted and lower
  case, without ``::`` and not starting with ``bench``; none opens in
  ``kernels/``; none is a user annotation (which the profiler would mirror
  onto the device's timeline);
- with no profiler running a span leaves nothing behind.
"""

import ast
import dataclasses
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import build
from repro_torch.models.attention import attention_apply
from repro_torch.models.common import apply_rope, materialize, rms_norm, split_rms_norm
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.model_zoo import extend_cache
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import init_state, make_train_step

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
B, S = 2, 16

#: Every span the package opens.
SPANS = ("serve.prefill", "serve.decode", "serve.generate", "serve.warmup", "serve.sync", "model.embed",
         "model.norm", "model.rope", "model.attention", "model.mlp", "model.cache", "model.unembed",
         "train.forward", "train.backward", "train.optimizer")


class Event:
    __slots__ = ("name", "start", "end", "tid", "user", "parent")

    def __init__(self, e):
        self.name, self.start, self.tid = e.name(), e.start_ns(), e.start_thread_id()
        self.end, self.user, self.parent = self.start + e.duration_ns(), e.is_user_annotation(), None

    def ancestors(self):
        op = self.parent
        while op is not None:
            yield op
            op = op.parent


def trace(fn) -> list:
    """The host events of ``fn()`` under a CPU profiler, each with its
    parent: the innermost event of its thread that encloses it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((Event(e) for e in prof.profiler.kineto_results.events()), key=lambda o: (o.start, -o.end))
    stacks: dict = {}
    for op in events:
        stack = stacks.setdefault(op.tid, [])
        while stack and stack[-1].end <= op.start:
            stack.pop()
        op.parent = stack[-1] if stack else None
        stack.append(op)
    return events


def named(events, name) -> list:
    return [e for e in events if e.name == name]


def under(events, name) -> list:
    """The events with a span ``name`` among their ancestors."""
    return [e for e in events if any(a.name == name for a in e.ancestors())]


@pytest.fixture(scope="module")
def served():
    """(api, engine, prompt) on the reduced internlm2 config."""
    cfg = get_config("internlm2-1.8b", reduced=True)
    api = build(cfg)
    params = materialize(api.params_def, torch.Generator().manual_seed(0), torch.bfloat16)
    engine = ServeEngine(api, ShapeConfig("s", S, B, "prefill"), params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    return api, engine, {"tokens": tokens}


@pytest.fixture(scope="module")
def prefill_events(served):
    _, engine, batch = served
    return trace(lambda: engine.prefill(batch))


@pytest.mark.parametrize("name,per_layer,once", [
    ("serve.sync", 0, 1), ("model.embed", 0, 1), ("model.norm", 2, 1), ("model.rope", 2, 0),
    ("model.attention", 1, 0), ("model.mlp", 1, 0), ("model.cache", 0, 1), ("model.unembed", 0, 1)])
def test_prefill_spans(served, prefill_events, name, per_layer, once):
    """``serve.prefill`` encloses ``name`` as often as the model opens it:
    ``per_layer`` times a layer and ``once`` more."""
    api, _, _ = served
    (call,) = named(prefill_events, "serve.prefill")
    found = named(prefill_events, name)
    assert len(found) == per_layer * api.cfg.num_layers + once
    assert all(call in e.ancestors() for e in found)
    if name == "model.rope":
        assert all(any(a.name == "model.attention" for a in e.ancestors()) for e in found)


@pytest.mark.parametrize("method", ["warmup", "prefill", "generate", "decode"])
def test_each_call_opens_its_span(served, method):
    """Each of ``ServeEngine``'s calls is one span of its name, enclosing the
    model's work (the unembedding) and the synchronise, on one thread."""
    api, engine, batch = served
    if method == "decode":
        cache = extend_cache(api, engine.prefill(batch)[1], 2)
        run = lambda: engine.decode_step(cache, batch["tokens"][:, :1], S)  # noqa: E731
        name = "serve.decode"
    else:
        run = {"warmup": lambda: engine.warmup(batch), "prefill": lambda: engine.prefill(batch),
               "generate": lambda: engine.generate(batch, 3)}[method]
        name = f"serve.{method}"
    events = trace(run)
    (call,) = named(events, name)
    for inner in ("model.unembed", "serve.sync"):
        found = named(events, inner)
        assert found and all(call in e.ancestors() for e in found), inner
    assert {e.tid for e in under(events, name)} == {call.tid}


#: (span, function of (a layer's parameters, x (B, S, d), x as heads, positions, config)).
ENCLOSING = {
    "rms_norm": ("model.norm", lambda p, x, xh, pos, cfg: rms_norm(x, p["ln1"], cfg.norm_eps)),
    "split_rms_norm": ("model.norm", lambda p, x, xh, pos, cfg: split_rms_norm(x, p["ln1"], cfg.norm_eps, None)),
    "apply_rope": ("model.rope", lambda p, x, xh, pos, cfg: apply_rope(xh, pos, cfg.rope_theta)),
    "attention_apply": ("model.attention", lambda p, x, xh, pos, cfg: attention_apply(p["attn"], x, pos, cfg)),
    "mlp_apply": ("model.mlp", lambda p, x, xh, pos, cfg: mlp_apply(p["mixer"], x, cfg)),
}


@pytest.mark.parametrize("fn", sorted(ENCLOSING))
def test_span_encloses_its_operators(served, fn):
    """The function opens its span once, and every operator it runs (the
    flash op's included) has that span as an ancestor."""
    api, engine, _ = served
    name, run = ENCLOSING[fn]
    x = torch.randn(B, S, api.cfg.d_model, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(3))
    xh, pos = x.reshape(B, S, -1, api.cfg.head_dim), torch.arange(S).expand(B, S)
    with torch.no_grad():
        events = trace(lambda: run(engine.params["layers"][0], x, xh, pos, api.cfg))
    ops = [e for e in events if e.name.startswith(("aten::", "repro_torch::"))]
    assert len(named(events, name)) == 1 and ops
    assert all(any(a.name == name for a in e.ancestors()) for e in ops)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_phases(remat):
    """forward, backward, optimizer in that order; AdamW's square root of
    each leaf under the optimizer; the recomputation of each layer under
    the backward with remat "full", none without."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True), compute_dtype="float32", remat=remat)
    api = build(cfg)
    ocfg = opt.OptimizerConfig(total_steps=10, warmup_steps=2)
    state = init_state(api, torch.Generator().manual_seed(0), ocfg)
    batch = synthetic_batch(api, ShapeConfig("t", S, B, "train"), 0)
    step = make_train_step(api, ocfg)
    events = trace(lambda: step(state, batch))
    (fwd,), (bwd,), (upd,) = (named(events, f"train.{p}") for p in ("forward", "backward", "optimizer"))
    assert fwd.end <= bwd.start and bwd.end <= upd.start
    leaves = sum(1 for _ in state.params.parameters())
    assert len([e for e in under(events, "train.optimizer") if e.name == "aten::sqrt"]) >= leaves
    recomputed = [e for e in under(events, "train.backward") if e.name == "model.mlp"]
    assert len(recomputed) == (cfg.num_layers if remat == "full" else 0)


@pytest.fixture(scope="module")
def all_events(served, prefill_events):
    """The host events of each of the engine's calls and of a train step."""
    api, engine, batch = served
    cache = extend_cache(api, engine.prefill(batch)[1], 2)
    events = list(prefill_events)
    for run in (lambda: engine.warmup(batch), lambda: engine.generate(batch, 2),
                lambda: engine.decode_step(cache, batch["tokens"][:, :1], S)):
        events += trace(run)
    ocfg = opt.OptimizerConfig(total_steps=10, warmup_steps=2)
    tcfg = dataclasses.replace(api.cfg, compute_dtype="float32")
    tapi = build(tcfg)
    step = make_train_step(tapi, ocfg)
    state = init_state(tapi, torch.Generator().manual_seed(0), ocfg)
    events += trace(lambda: step(state, synthetic_batch(tapi, ShapeConfig("t", S, B, "train"), 0)))
    return events


@pytest.mark.parametrize("name", SPANS)
def test_span_name_and_kind(all_events, name):
    """The span is opened, named as a span (never as an operator, never as
    the benchmark's), and is not a user annotation."""
    found = named(all_events, name)
    assert found
    assert re.fullmatch(r"[a-z]+(\.[a-z]+)+", name) and "::" not in name and not name.startswith("bench")
    assert not any(e.user for e in found)


def test_every_span_literal_is_listed():
    """Each ``span(...)`` of the package names one of ``SPANS`` by a
    literal, and none is opened in ``kernels/`` (a custom op's body)."""
    found = {}
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span":
                arg = node.args[0] if node.args else None
                found.setdefault(path.relative_to(PKG).as_posix(), set()).add(
                    arg.value if isinstance(arg, ast.Constant) else None)
    assert found and not [p for p in found if p.startswith("kernels/")]
    names = set().union(*found.values())
    assert names == set(SPANS), names ^ set(SPANS)


def test_user_annotation_is_seen():
    """The check above can fail: ``record_function`` is a user annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("x.y"):
            torch.ones(2).add_(1)
    assert [e.is_user_annotation() for e in prof.profiler.kineto_results.events() if e.name() == "x.y"] == [True]


def test_span_without_profiler_keeps_nothing():
    """With no profiler running, spans (nested, or left by an exception)
    record nothing and leave nothing for a later trace; each call makes a
    fresh object."""
    assert not torch.autograd._profiler_enabled()
    assert spans.span("model.norm") is not spans.span("model.norm")
    with spans.span("model.norm"):
        with spans.span("model.rope"):
            torch.ones(2).add_(1)
    with pytest.raises(ValueError):
        with spans.span("model.mlp"):
            raise ValueError("escapes the span")
    events = trace(lambda: torch.ones(2).add_(1))
    assert [e.name for e in events if not e.name.startswith("aten::")] == []
    assert not torch.autograd._profiler_enabled()
