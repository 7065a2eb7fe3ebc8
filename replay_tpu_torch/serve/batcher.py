"""Request micro-batcher: fixed-slot batches under a max-wait deadline.

Copied from ``replay_tpu/serve/batcher.py`` (host-only).

The serving counterpart of ``SequenceBatcher``'s static-shape rule: the engine
runs a handful of fixed bucket shapes, live traffic arrives one request at a time, so
concurrent requests are collected into per-lane queues (a lane = one compiled
program family, e.g. ``encode:L=16`` or ``hit``) and dispatched as a batch
when either the lane FILLS its largest compiled bucket or the OLDEST request's
deadline (``max_wait`` after enqueue) expires — whichever comes first. Partial
batches are padded up to the nearest bucket by the engine and masked by row
validity, so a lone request costs one bucket-1 program, not a 512-wide slot.

Single worker thread: every dispatch (and therefore every device call) runs on
it sequentially — the accelerator is a serial resource anyway, and it keeps
the device work on one thread (and one CUDA stream).

Resilience contract (docs/serving.md "Overload and degradation"):

* **admission control** — ``max_depth`` bounds each lane's queue; a submit
  into a full lane raises :class:`~replay_tpu_torch.serve.errors.RequestShed`
  (depth + retry-after hint) instead of growing the backlog without bound.
* **supervision** — a worker crash (``on_error`` raising, or a non-``Exception``
  ``BaseException`` escaping a dispatch) fails the in-flight batch through
  ``on_error`` and restarts the loop, up to ``max_worker_restarts`` times;
  past the budget every queued item is failed with
  :class:`~replay_tpu_torch.serve.errors.ServiceClosed` and the batcher refuses new
  work. Plain dispatch ``Exception``s still route to ``on_error`` without
  costing a restart.
* **no orphaned waiters** — ``stop()`` flushes what it can through
  ``dispatch`` and FAILS whatever remains (worker dead, or wedged past the
  join timeout — including the in-flight batch), so no submitted item is ever
  left unresolved.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from .errors import RequestShed, ServiceClosed


class MicroBatcher:
    """Collects submitted items into per-lane batches; a worker thread calls
    ``dispatch(lane, items)`` when a lane fills or its oldest item times out.

    :param dispatch: callback run ON THE WORKER THREAD with at most
        ``capacity(lane)`` items. ``Exception``s are routed to ``on_error``
        (the worker survives); anything ``on_error`` raises crashes the worker
        into the supervisor.
    :param capacity: max items per dispatched batch, per lane — the largest
        compiled batch bucket. Either a mapping or a default int for lanes not
        listed.
    :param max_wait: seconds a request may wait for co-riders before a partial
        batch is dispatched anyway (the latency/fill trade-off knob).
    :param on_error: ``(lane, items, exception) -> None``; resolves the failed
        items' futures at the service layer.
    :param max_depth: per-lane queued-item bound; ``None`` = unbounded (the
        pre-resilience behavior). Submits beyond it raise :class:`RequestShed`.
    :param max_worker_restarts: worker crashes tolerated before the batcher
        gives up and fails all pending work.
    """

    def __init__(
        self,
        dispatch: Callable[[Hashable, List[Any]], None],
        capacity: Any = 64,
        max_wait: float = 0.002,
        on_error: Optional[Callable[[Hashable, List[Any], BaseException], None]] = None,
        max_depth: Optional[int] = None,
        max_worker_restarts: int = 2,
    ) -> None:
        self._dispatch = dispatch
        self._capacity = capacity if isinstance(capacity, dict) else {}
        self._default_capacity = (
            max(self._capacity.values()) if isinstance(capacity, dict) and self._capacity
            else int(capacity) if not isinstance(capacity, dict) else 64
        )
        self.max_wait = float(max_wait)
        self.max_depth = int(max_depth) if max_depth is not None else None
        self.max_worker_restarts = int(max_worker_restarts)
        self._on_error = on_error
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._lanes: Dict[Hashable, deque] = {}
        self._running = False
        self._worker: Optional[threading.Thread] = None
        self._inflight: Optional[Tuple[Hashable, List[Any]]] = None
        self._dispatch_ewma = 0.0  # recent seconds per dispatched batch
        # accounting (under _lock)
        self.submitted = 0
        self.dispatched_batches = 0
        self.dispatched_rows = 0
        self.deadline_flushes = 0
        self.full_flushes = 0
        self.shed = 0
        self.worker_crashes = 0

    def capacity(self, lane: Hashable) -> int:
        return int(self._capacity.get(lane, self._default_capacity))

    # -- client side -------------------------------------------------------- #
    def submit(self, lane: Hashable, item: Any) -> None:
        """Enqueue ``item`` on ``lane`` (any thread).

        Raises :class:`ServiceClosed` once stopped (or crashed past the
        restart budget) and :class:`RequestShed` when the lane is at
        ``max_depth`` — both BEFORE the item is queued, so admission refusals
        never leave dangling state.
        """
        deadline = time.perf_counter() + self.max_wait
        with self._wake:
            if not self._running:
                raise ServiceClosed("MicroBatcher is not running")
            queue = self._lanes.setdefault(lane, deque())
            if self.max_depth is not None and len(queue) >= self.max_depth:
                self.shed += 1
                raise RequestShed(
                    lane,
                    depth=len(queue),
                    max_depth=self.max_depth,
                    retry_after_s=self._retry_after_locked(lane, len(queue)),
                )
            queue.append((deadline, item))
            self.submitted += 1
            self._wake.notify()

    @property
    def live(self) -> bool:
        """Whether the batcher currently accepts work (the fleet heartbeat's
        liveness bit): running and not crashed past the restart budget."""
        with self._lock:
            return self._running

    @property
    def idle(self) -> bool:
        """True when nothing is queued on any lane AND no batch is in flight
        — the drain protocol's 'safe to swap weights' condition."""
        with self._lock:
            return self._inflight is None and not any(self._lanes.values())

    def queued_depth(self, lane: Optional[Hashable] = None) -> int:
        """Items currently queued on ``lane`` (or across all lanes)."""
        with self._lock:
            if lane is not None:
                queue = self._lanes.get(lane)
                return len(queue) if queue else 0
            return sum(len(queue) for queue in self._lanes.values())

    def _retry_after_locked(self, lane: Hashable, depth: int) -> float:
        """Rough backlog-drain estimate: batches ahead x recent per-batch
        dispatch time, plus one max-wait for the fill window."""
        batches_ahead = max(depth, 1) / max(self.capacity(lane), 1)
        return batches_ahead * self._dispatch_ewma + self.max_wait

    # -- worker ------------------------------------------------------------- #
    def _pick(self, now: float) -> Optional[Tuple[Hashable, List[Any], bool]]:
        """Under the lock: (lane, items, was_full) ready to dispatch, or None.

        Expired deadlines win over full lanes: under sustained load one lane
        can be full on every worker iteration, and preferring it would let
        another lane's requests age unboundedly past ``max_wait`` — the
        contract is fill OR deadline, *whichever comes first*, per lane.
        """
        oldest_lane = None
        oldest_deadline = None
        full_lane = None
        for lane, queue in self._lanes.items():
            if not queue:
                continue
            if full_lane is None and len(queue) >= self.capacity(lane):
                full_lane = lane
            if oldest_deadline is None or queue[0][0] < oldest_deadline:
                oldest_deadline = queue[0][0]
                oldest_lane = lane
        if oldest_lane is not None and oldest_deadline <= now:
            was_full = len(self._lanes[oldest_lane]) >= self.capacity(oldest_lane)
            return oldest_lane, self._drain(oldest_lane), was_full
        if full_lane is not None:
            return full_lane, self._drain(full_lane), True
        return None

    def _drain(self, lane: Hashable) -> List[Any]:
        queue = self._lanes[lane]
        items = [queue.popleft()[1] for _ in range(min(len(queue), self.capacity(lane)))]
        return items

    def _next_deadline(self) -> Optional[float]:
        deadlines = [q[0][0] for q in self._lanes.values() if q]
        return min(deadlines) if deadlines else None

    def _run(self) -> None:
        """Worker main: the dispatch loop under a crash supervisor."""
        while True:
            try:
                self._loop()
                return  # clean exit: stopped and drained
            except BaseException as exc:  # noqa: BLE001 — supervised crash
                if not self._crashed(exc):
                    return
                # budget remains: loop around = the restart

    def _crashed(self, exc: BaseException) -> bool:
        """Fail the in-flight batch, decide restart vs give-up. Returns
        whether the loop should restart."""
        with self._wake:
            inflight, self._inflight = self._inflight, None
            self.worker_crashes += 1
            restart = self._running and self.worker_crashes <= self.max_worker_restarts
            if not restart:
                self._running = False  # refuse new work; pending fails below
        if inflight is not None:
            self._safe_on_error(inflight[0], inflight[1], exc)
        if not restart:
            self._fail_pending(
                ServiceClosed(
                    f"serve worker crashed ({exc!r}) and exhausted its "
                    f"{self.max_worker_restarts}-restart budget"
                )
            )
        return restart

    def _loop(self) -> None:
        while True:
            with self._wake:
                ready = self._pick(time.perf_counter())
                if ready is None:
                    if not self._running and not any(self._lanes.values()):
                        return
                    deadline = self._next_deadline()
                    if self._running:
                        timeout = (
                            None if deadline is None
                            else max(deadline - time.perf_counter(), 0.0)
                        )
                        self._wake.wait(timeout=timeout)
                        continue
                    # draining after stop(): flush whatever remains, no waiting
                    for lane, queue in self._lanes.items():
                        if queue:
                            ready = lane, self._drain(lane), False
                            break
                    if ready is None:
                        return
                lane, items, was_full = ready
                self.dispatched_batches += 1
                self.dispatched_rows += len(items)
                if was_full:
                    self.full_flushes += 1
                else:
                    self.deadline_flushes += 1
                self._inflight = (lane, items)
            started = time.perf_counter()
            try:
                self._dispatch(lane, items)
            except Exception as exc:  # noqa: BLE001 — worker survives
                # on_error raising (or a BaseException from dispatch) escapes
                # to the supervisor with _inflight still set, so the crashed
                # batch's items are failed rather than lost
                if self._on_error is not None:
                    self._on_error(lane, items, exc)
            elapsed = time.perf_counter() - started
            with self._wake:
                self._inflight = None
                self._dispatch_ewma = (
                    elapsed if not self._dispatch_ewma
                    else 0.8 * self._dispatch_ewma + 0.2 * elapsed
                )

    # -- failure resolution -------------------------------------------------- #
    def _safe_on_error(self, lane, items: List[Any], exc: BaseException) -> None:
        if self._on_error is None:
            return
        try:
            self._on_error(lane, items, exc)
        except Exception:  # noqa: BLE001 — resolution is best-effort by here
            pass

    def _fail_pending(self, exc: BaseException) -> None:
        """Drain every lane, failing each batch through ``on_error`` — the
        no-orphaned-waiters backstop for crash/stop paths."""
        while True:
            with self._wake:
                batch = None
                for lane, queue in self._lanes.items():
                    if queue:
                        batch = lane, [queue.popleft()[1] for _ in range(len(queue))]
                        break
                if batch is None:
                    return
            self._safe_on_error(batch[0], batch[1], exc)

    # -- lifecycle ---------------------------------------------------------- #
    def start(self) -> "MicroBatcher":
        with self._wake:
            if self._running:
                return self
            self._running = True
            self.worker_crashes = 0
            worker = self._worker
            if worker is not None and worker.is_alive():
                # a previous stop() timed out on a wedged dispatch: that
                # thread still owns the dispatch loop and resumes it when the
                # dispatch returns — spawning a second worker here would put
                # two threads on the device path (the single-worker invariant)
                self._wake.notify_all()
                return self
        self._worker = threading.Thread(target=self._run, name="serve-microbatcher", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop accepting work, flush queued items through ``dispatch``, join.

        If the worker is dead or wedged past ``timeout``, every remaining item
        — queued AND in flight — is failed through ``on_error`` instead: a
        submitted item never outlives ``stop()`` unresolved.
        """
        with self._wake:
            if not self._running and self._worker is None:
                return
            self._running = False
            self._wake.notify_all()
        worker = self._worker
        if worker is not None:
            worker.join(timeout=timeout)
            if not worker.is_alive():
                self._worker = None
            # a wedged worker keeps its handle: a later start() must resume
            # it, never run a second dispatcher beside it
        # a healthy worker drained everything before exiting; leftovers mean
        # it crashed out or is wedged in a dispatch — fail them, don't hang
        self._fail_pending(
            ServiceClosed("MicroBatcher stopped before this request was served")
        )
        if worker is not None and worker.is_alive():
            with self._wake:
                inflight, self._inflight = self._inflight, None
            if inflight is not None:
                self._safe_on_error(
                    inflight[0],
                    inflight[1],
                    ServiceClosed(
                        "MicroBatcher stopped while this batch was in flight "
                        "(worker wedged past the join timeout)"
                    ),
                )

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "submitted": self.submitted,
                "dispatched_batches": self.dispatched_batches,
                "dispatched_rows": self.dispatched_rows,
                "deadline_flushes": self.deadline_flushes,
                "full_flushes": self.full_flushes,
                "shed": self.shed,
                "worker_crashes": self.worker_crashes,
                "queued": sum(len(queue) for queue in self._lanes.values()),
                "max_depth": self.max_depth,
            }
