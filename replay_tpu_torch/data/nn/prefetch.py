"""Background-thread batch prefetching and the device-feed stage.

Counterpart of ``replay_tpu/data/nn/prefetch.py``, with the same order,
exception, ``close``/join and ``depth`` semantics. Two stages:

* :func:`prefetch` — one daemon thread stays ahead of the training loop by
  ``depth`` batches (host numpy work only), hiding host-side batch building
  behind the device step.
* :class:`DevicePrefetcher` — the device-feed stage for the scan-chunked fit
  (``Trainer.fit(scan_chunk=K)``): a feeder thread applies a caller-supplied
  ``place`` callable to each work item (the trainer's stacks a chunk into
  pinned host memory and copies it to the card with ``non_blocking=True`` on a
  side stream, recording an event that the consumer's stream waits on), so
  the host→device copy of chunk *n+1* overlaps chunk *n*'s replay instead of
  serializing with it. Double-buffered and bounded: up to ``depth + 1``
  placed items can exist at once (``depth`` queued plus the one the feeder
  holds while blocked on a full queue), in addition to whatever the consumer
  is executing. The trainer's chunk graph reads the placed chunk by a copy
  into its own static buffer, so a placed chunk is never written by a replay.

Both stages share one close protocol: the producer uses a plain blocking
``Queue.put`` (no busy-wait), and closing the consumer (``close()`` /
``GeneratorExit`` / garbage collection) signals the producer, drains the queue
to unblock any pending put, and **joins the thread**, so abandoned iterators
do not leak daemon threads or keep consuming the source.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

logger = logging.getLogger("replay_tpu_torch")

_SENTINEL = object()

# how long close() waits for the producer thread to exit before giving up and
# leaving the (daemon) thread behind — only reachable when the SOURCE iterator
# itself blocks indefinitely inside next()
_JOIN_TIMEOUT_SECONDS = 5.0


def prefetch(batches: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``batches`` with a ``depth``-deep background producer thread.

    Exceptions in the producer are re-raised in the consumer at the point of
    consumption. Abandoning the iterator (``close()``/``GeneratorExit`` — e.g.
    the training loop raised) signals the producer to stop AND joins the
    thread, so neither the thread nor its buffered batches outlive the
    consumer.
    """
    if depth < 1:
        msg = "depth must be >= 1"
        raise ValueError(msg)
    return _pipeline(batches, depth, transform=None)


def _pipeline(
    source: Iterable, depth: int, transform: Optional[Callable[[Any], Any]]
) -> Iterator:
    """Producer-thread pipeline shared by :func:`prefetch` (transform=None →
    yields items) and :class:`DevicePrefetcher` (yields ``(item,
    transform(item))`` pairs, the transform running ON the producer thread)."""
    buffer: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def emit(payload) -> bool:
        """Blocking put; close() drains the queue to unblock it. Returns False
        once the consumer has gone away."""
        if stop.is_set():
            return False
        buffer.put(payload)
        return not stop.is_set()

    def producer() -> None:
        try:
            for item in source:
                payload = item if transform is None else (item, transform(item))
                if not emit(payload):
                    return
        except BaseException as error:  # noqa: BLE001 - relayed to the consumer
            emit((_SENTINEL, error))
            return
        emit((_SENTINEL, None))

    thread = threading.Thread(
        target=producer,
        daemon=True,
        name="replay-tpu-torch-prefetch" if transform is None else "replay-tpu-torch-device-feed",
    )
    thread.start()
    try:
        while True:
            item = buffer.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        deadline = time.monotonic() + _JOIN_TIMEOUT_SECONDS
        while thread.is_alive():
            try:  # unblock a producer waiting on a full queue
                while True:
                    buffer.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                # the SOURCE is stuck inside next(): the thread is daemonic, so
                # it cannot keep the process alive — report and move on rather
                # than hang the consumer's close() forever
                logger.warning(
                    "prefetch: producer thread did not exit within %.1fs of close "
                    "(source iterator blocked?); leaving daemon thread behind",
                    _JOIN_TIMEOUT_SECONDS,
                )
                break


class DevicePrefetcher:
    """Feed device-placed work items one step ahead of the consumer.

    Wraps an iterator of work items with a feeder thread that applies
    ``place`` to each item as soon as a buffer slot frees up, yielding
    ``(item, place(item))`` pairs in source order. With ``depth=1`` (double
    buffering) the feeder is stacking + placing chunk *n+1* while the consumer
    executes chunk *n* — the H2D copy overlaps compute. Device-memory bound:
    the feeder places the NEXT item before blocking on a full queue, so up to
    ``depth + 1`` placed items are resident beyond the one the consumer holds
    — size chunks against ``depth + 2`` batches' worth of device memory.

    ``place`` runs on the feeder thread. On the card it should make its
    copies on a stream of its own and hand the consumer an event to wait on
    (the trainer's does), so that the copies run beside the consumer's
    kernels. It may return ``None`` for items that should pass through
    unplaced (the trainer's short-tail single steps, which the per-step path
    places itself).

    Exceptions raised by the source or by ``place`` re-raise in the consumer
    at the point of consumption. :meth:`close` (also called by ``with`` exit
    and garbage collection) stops and joins the feeder thread.
    """

    def __init__(
        self,
        items: Iterable,
        place: Callable[[Any], Any],
        depth: int = 1,
    ) -> None:
        if depth < 1:
            msg = "depth must be >= 1"
            raise ValueError(msg)
        self._gen: Iterator[Tuple[Any, Any]] = _pipeline(items, depth, transform=place)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Tuple[Any, Any]:
        return next(self._gen)

    def close(self) -> None:
        """Stop the feeder thread and join it (idempotent)."""
        self._gen.close()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
