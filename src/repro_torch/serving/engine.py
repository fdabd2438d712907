"""Serve engine: prefill/decode execution for one model instance -- the twin
of the reference's ``repro/serving/engine.py``.

One ``ServeEngine`` = one warm "sandbox" in FaaS terms: parameters on a
device plus the prefill and decode steps for a (batch, seq) bucket.  PyTorch
runs eagerly, so there is nothing to compile; the cold start (``warmup``)
is the first prefill, which loads the kernels and the library handles.
Every timed call ends in ``torch.cuda.synchronize`` on the card where the
reference ends in ``block_until_ready``.  Each call's model work and
synchronise run in a host span (``spans.span``) named after the call
(``serve.prefill``, ``serve.decode``, ``serve.generate``,
``serve.warmup``), the synchronise in ``serve.sync``.  The reference
donates the cache to its decode step; here the decode step writes the
cache in place.

A VLM request's first decode step writes after its patch embeddings and
its tokens (``model_zoo.prompt_length``).  The reference's ``generate``
starts at the token count alone, which overwrites a prompt row and hides
the last ones from attention; the port does not copy that.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.model_zoo import ModelApi, extend_cache, prompt_length
from repro_torch.serving.kv_cache import init_cache
from repro_torch.spans import span


@dataclasses.dataclass
class InvocationRecord:
    function: str
    start: float
    end: float
    kind: str          # prefill | decode | generate
    tokens: int = 0

    @property
    def latency(self) -> float:
        return self.end - self.start


class ServeEngine:
    """Prefill + decode for one arch at one shape bucket, on the device its
    parameters live on."""

    def __init__(self, api: ModelApi, shape: ShapeConfig, params: Any, *, clock=time.perf_counter):
        self.api = api
        self.shape = shape
        self.params = params
        self.clock = clock
        self.device = next(params.parameters()).device
        self.records: list[InvocationRecord] = []
        self.cold = True

    def _sync(self) -> None:
        with span("serve.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def warmup(self, batch: dict) -> None:
        """Cold start: the first prefill (kernel and library loading)."""
        with span("serve.warmup"):
            self.api.prefill(self.params, batch)
            self._sync()
        self.cold = False

    @torch.no_grad()
    def prefill(self, batch: dict, *, t0: float | None = None):
        start = self.clock() if t0 is None else t0
        with span("serve.prefill"):
            logits, cache = self.api.prefill(self.params, batch)
            self._sync()
        end = self.clock()
        self.records.append(InvocationRecord("prefill", start, end, "prefill", batch["tokens"].numel()))
        return logits, cache

    @torch.no_grad()
    def generate(self, batch: dict, steps: int, *, greedy: bool = True):
        """Prefill then ``steps - 1`` greedy decode steps: ``steps`` tokens
        per sequence, (B, steps) int32.  Tokens stay on the device; the only
        host synchronisation is the one at the end.  The greedy argmax runs
        over the padded vocabulary, as the reference's does; like the
        reference's, it takes the argmax whatever ``greedy`` says (the
        reference has no sampling path)."""
        start = self.clock()
        with span("serve.generate"):
            logits, cache = self.api.prefill(self.params, batch)
            cache = extend_cache(self.api, cache, steps)
            b = logits.shape[0]
            pos0 = prompt_length(batch)
            toks = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)]
            for i in range(steps - 1):
                logits, cache = self.api.decode(self.params, cache, toks[-1][:, None], pos0 + i)
                toks.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
            out = torch.stack(toks, dim=1)
            self._sync()
        end = self.clock()
        self.records.append(InvocationRecord("generate", start, end, "generate", int(b * steps)))
        return out

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        start = self.clock()
        with span("serve.decode"):
            logits, cache = self.api.decode(self.params, cache, token, pos)
            self._sync()
        end = self.clock()
        self.records.append(InvocationRecord("decode", start, end, "decode", logits.shape[0]))
        return logits, cache

    def fresh_cache(self):
        return init_cache(self.api, self.shape, device=self.device)
