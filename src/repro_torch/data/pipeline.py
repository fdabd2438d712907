"""Host-side data pipeline -- the twin of the reference's
``repro/data/pipeline.py``: deterministic synthetic training batches per
``ModelApi`` spec, and a background prefetch stage for any iterator.

The pipeline is spec-driven: it reads ``api.train_inputs(shape)`` and
synthesises matching batches, so one iterator serves every family (LM
tokens, VLM patch embeddings, encoder-decoder frame embeddings).  Batch
``i`` is a pure function of (seed, i), drawn with numpy from
``SeedSequence([seed, i])`` in the specs' order, exactly as the reference
draws it, so the port's batches are the reference's bit for bit and a
restarted trainer resumes on the same data (the iterator is seekable).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distributed.sharding import place

#: numpy twin of each integer spec dtype (the token-like inputs).
_NP_INT = {torch.int32: np.int32, torch.int64: np.int64}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Synthetic LM stream: tokens follow a Zipf-like law so the loss has
    # signal (uniform tokens keep the CE flat at ln V).
    zipf_a: float = 1.2


def _leaf_batch(spec, rng: np.random.Generator, vocab_size: int, zipf_a: float) -> torch.Tensor:
    """One input: token-like (integer) specs draw Zipf ids over the true
    vocabulary; float specs standard normals times 0.1 (float64, rounded
    once to the spec's dtype, as the reference's ``astype``)."""
    if not spec.dtype.is_floating_point:
        z = rng.zipf(zipf_a, size=spec.shape).astype(np.int64)
        return torch.from_numpy(np.minimum(z - 1, vocab_size - 1).astype(_NP_INT[spec.dtype]))
    return torch.from_numpy(rng.standard_normal(spec.shape) * 0.1).to(spec.dtype)


def synthetic_batch(api, shape: ShapeConfig, step: int, config: DataConfig = DataConfig()) -> dict:
    """Batch ``step`` of the deterministic synthetic stream, as host (CPU)
    tensors of the specs' dtypes; labels are the tokens shifted by one
    (-1 at the end), the real LM objective on the stream."""
    rng = np.random.default_rng(np.random.SeedSequence([config.seed, step]))
    batch = {name: _leaf_batch(spec, rng, api.cfg.vocab_size, config.zipf_a)
             for name, spec in api.train_inputs(shape).items()}
    if "labels" in batch and "tokens" in batch:
        toks = batch["tokens"]
        batch["labels"] = torch.cat([toks[:, 1:], toks.new_full((toks.shape[0], 1), -1)], dim=1)
    return batch


def batch_iterator(api, shape: ShapeConfig, config: DataConfig = DataConfig(), *, start_step: int = 0,
                   device: str | torch.device = "cpu", shardings: Any = None) -> Iterator[dict]:
    """Seekable infinite iterator of ``synthetic_batch`` from
    ``start_step`` on, each batch moved to ``device``, or, given
    ``shardings`` (``train_step.batch_shardings``), placed on them: every
    rank draws the same host batch and keeps its own block
    (``distributed.sharding.place``; the whole batch on a one-device mesh)."""
    step = start_step
    while True:
        host = synthetic_batch(api, shape, step, config)
        if shardings is not None:
            yield {k: place(v, shardings[k]) for k, v in host.items()}
        else:
            yield {k: v.to(device) for k, v in host.items()}
        step += 1


def prefetch_iterator(it: Iterator[Any], size: int = 2, *,
                      transfer: Callable[[Any], Any] | None = None) -> Iterator[Any]:
    """Run ``it`` on a background thread, ``size`` elements ahead.

    The producer thread fills a bounded queue while the consumer drains it,
    so host-side work (telemetry sensing, batch synthesis, a host-to-device
    copy) overlaps the consumer's dispatches.  ``transfer`` (e.g. a
    ``.to(device, non_blocking=True)`` over a batch) runs on the producer
    thread on each element before it is queued, so the consumer only ever
    sees transferred elements.

    Exceptions raised by ``it`` or ``transfer`` re-raise at the consuming
    ``next()`` call with the producer's traceback attached.  When the
    consumer abandons the iterator early (``close()``/GC of the generator,
    or an exception in the consuming loop), the producer thread is
    signalled to stop and *joined* (bounded wait) before control returns,
    so a caller layering more background stages on top (the drain thread of
    ``StreamingFleetSession.ingest``) never leaks a producer still touching
    the source iterator.  The producer is a daemon, so one blocked inside
    the source iterator can hang neither the join (it is abandoned after the
    timeout) nor interpreter exit.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    q: "queue.Queue[tuple[Any, Any]]" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def _put(entry: tuple[Any, Any]) -> bool:
        # Bounded-blocking put: wake up periodically to notice an abandoned
        # consumer (the queue is full and nobody will ever drain it).
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce() -> None:
        try:
            for item in it:
                if not _put((item if transfer is None else transfer(item), None)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            _put((done, e))
        else:
            _put((done, None))

    producer = threading.Thread(target=_produce, daemon=True, name="prefetch-producer")
    producer.start()
    try:
        while True:
            item, err = q.get()
            if item is done:
                if err is not None:
                    raise err
                return
            yield item
    finally:
        stop.set()
        producer.join(timeout=5.0)
