"""Shared future-resolution helpers for the serve stack.

Copied from ``replay_tpu/serve/futures.py`` (host-only).

One request = one :class:`concurrent.futures.Future`, resolved exactly once —
but resolvers race: the dispatch worker against a client-side ``cancel()``,
the fleet's hedge twins against each other, close() against an in-flight
batch. These helpers make every resolution attempt idempotent and
loss-free: they return whether THIS caller won the resolution, and losing
(the future was already done, or a racer beat us between the ``done()``
check and the commit) is never an exception. Used by both
:class:`~replay_tpu_torch.serve.ScoringService` and
:class:`~replay_tpu_torch.serve.ServingFleet`.
"""

from __future__ import annotations

from concurrent.futures import Future, InvalidStateError

__all__ = ["mark_running", "safe_fail", "safe_set_result"]


def safe_fail(future: "Future", exc: BaseException) -> bool:
    """Fail ``future`` with ``exc`` unless already resolved; True when this
    call did the failing."""
    try:
        if not future.done():
            future.set_exception(exc)
            return True
    except InvalidStateError:
        pass
    return False


def safe_set_result(future: "Future", result) -> bool:
    """Resolve ``future`` with ``result`` unless already resolved; True when
    this call did the resolving."""
    try:
        if not future.done():
            future.set_result(result)
            return True
    except InvalidStateError:
        pass
    return False


def mark_running(future: "Future") -> bool:
    """Commit ``future`` to RUNNING (a late ``cancel()`` no longer bites);
    False when it was cancelled — or already finished by a racer (a finished
    future raises bare ``RuntimeError`` here, NOT ``InvalidStateError``)."""
    try:
        return future.set_running_or_notify_cancel()
    except RuntimeError:
        return False
