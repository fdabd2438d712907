"""Host-side data pipeline: a background prefetch stage for any iterator.

A copy of the reference's ``prefetch_iterator`` (threading only).
``synthetic_batch`` and ``batch_iterator`` of the reference's module feed
the model zoo and wait for its model-family slices.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator


def prefetch_iterator(it: Iterator[Any], size: int = 2) -> Iterator[Any]:
    """Run ``it`` on a background thread, ``size`` elements ahead.

    The producer thread fills a bounded queue while the consumer drains it,
    so host-side work (telemetry sensing) overlaps the consumer's dispatches.

    Exceptions raised by ``it`` re-raise at the consuming
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
                if not _put((item, None)):
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
