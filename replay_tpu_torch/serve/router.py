"""Fleet routing primitives: the hash ring, replica health, retry backoff.

Copied from ``replay_tpu/serve/router.py`` (host-only, stdlib only): the
host-side half of scaling :class:`~replay_tpu_torch.serve.ScoringService`
out to N replicas (``serve/fleet.py``), testable without a device — the same
split as ``batcher``/``breaker`` vs ``engine``. ``_hash64`` is the JAX
package's byte for byte, so a user id maps to the same replica in both.

* :class:`HashRing` — consistent hashing with virtual nodes. Users map to a
  point on a 64-bit ring; the owning replica is the first vnode clockwise.
  Adding or removing ONE replica remaps only the keys whose arcs it
  gains/loses — ~1/N of the population — so the per-user state caches on the
  other replicas stay hot through membership changes (bounded movement is
  measured, not assumed: ``tests/_torch/test_torch_fleet.py``). The hash is
  deterministic across processes (blake2b, no PYTHONHASHSEED dependence),
  like :func:`~replay_tpu_torch.serve.promote.in_canary_slice`.
* :class:`ReplicaHealth` — the per-replica health state machine
  ``healthy → degraded → draining → dead`` the fleet's monitor drives from
  heartbeats plus each replica's own exporter gauges (lane depth, breaker
  state, error rate). ``healthy``/``degraded`` replicas take traffic
  (degraded ones only as a home replica, never as a hedge/failover target);
  ``draining`` replicas finish their in-flight work but accept nothing new
  (the weight-swap window); ``dead`` replicas are skipped entirely and their
  users fail over to the next replica on the ring.
* :class:`BackoffPolicy` — capped exponential backoff for router-level
  retries that HONORS the service's own ``retry_after_s`` hint: a
  :class:`~replay_tpu_torch.serve.errors.RequestShed` carries the shedding lane's
  backlog-drain estimate, and retrying earlier than that is just load the
  lane already refused once.
"""

from __future__ import annotations

import hashlib
import threading
import time
from bisect import bisect_right
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

__all__ = ["REPLICA_HEALTH", "BackoffPolicy", "HashRing", "ReplicaHealth"]

# health states in degradation order; the first two accept traffic
REPLICA_HEALTH = ("healthy", "degraded", "draining", "dead")

# which transitions the state machine accepts (anything else raises: a fleet
# that silently "revives" a draining replica mid-swap is exactly the bug this
# table exists to refuse)
_TRANSITIONS = {
    "healthy": ("degraded", "draining", "dead"),
    "degraded": ("healthy", "draining", "dead"),
    "draining": ("healthy", "dead"),
    "dead": ("healthy",),
}


def _hash64(key: Hashable) -> int:
    """Deterministic 64-bit ring position (process-independent: every router
    in the fleet — and every process of a multi-host job — must agree on
    where a user lives)."""
    digest = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class HashRing:
    """Consistent-hash ring mapping users to replica ids, with vnodes.

    :param replicas: initial replica ids (any hashable, typically strings).
    :param vnodes: virtual nodes per replica — more vnodes = smoother load
        split and smaller movement variance on membership changes, at O(R x V)
        ring size. 64 keeps the max/mean load imbalance within ~20% for small
        fleets.

    Thread-safe: routing reads and membership writes share one lock (routing
    is a bisect over a sorted list — the lock is nanoseconds, not a choke
    point at serving rates).
    """

    def __init__(self, replicas: Tuple[Hashable, ...] = (), vnodes: int = 64) -> None:
        if vnodes < 1:
            msg = f"vnodes must be >= 1, got {vnodes}"
            raise ValueError(msg)
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._points: List[Tuple[int, Hashable]] = []  # sorted by hash
        self._replicas: Dict[Hashable, List[int]] = {}
        for replica in replicas:
            self.add(replica)

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    @property
    def replicas(self) -> List[Hashable]:
        with self._lock:
            return list(self._replicas)

    def add(self, replica_id: Hashable) -> None:
        with self._lock:
            if replica_id in self._replicas:
                return
            hashes = [
                _hash64((replica_id, vnode)) for vnode in range(self.vnodes)
            ]
            self._replicas[replica_id] = hashes
            self._points.extend((h, replica_id) for h in hashes)
            self._points.sort()

    def remove(self, replica_id: Hashable) -> None:
        with self._lock:
            if replica_id not in self._replicas:
                return
            del self._replicas[replica_id]
            self._points = [p for p in self._points if p[1] != replica_id]

    def route(self, user_id: Hashable) -> Hashable:
        """The user's HOME replica (first vnode clockwise of the user's hash).

        Membership-only function of the ring: health is the fleet's concern —
        a dead home replica means :meth:`preference`'s NEXT entry serves, and
        the user comes back home on revival (their cache is still there).
        """
        preference = self.preference(user_id, limit=1)
        if not preference:
            msg = "hash ring is empty (no replicas registered)"
            raise LookupError(msg)
        return preference[0]

    def preference(self, user_id: Hashable, limit: Optional[int] = None) -> List[Hashable]:
        """Distinct replicas in ring order starting at the user's hash point —
        the failover/hedge order: entry 0 is home, entry 1 is where the user
        fails over (and is therefore the hedge target), and so on."""
        with self._lock:
            if not self._points:
                return []
            if limit is None:
                limit = len(self._replicas)
            start = bisect_right(self._points, (_hash64(user_id), chr(0x10FFFF)))
            seen: List[Hashable] = []
            for offset in range(len(self._points)):
                replica = self._points[(start + offset) % len(self._points)][1]
                if replica not in seen:
                    seen.append(replica)
                    if len(seen) >= limit:
                        break
            return seen

    def spread(self, sample: int = 10_000) -> Dict[Hashable, float]:
        """Fraction of ``sample`` synthetic keys landing on each replica —
        the load-balance introspection number (and the test's material)."""
        counts: Dict[Hashable, int] = {}
        for key in range(sample):
            home = self.route(("spread", key))
            counts[home] = counts.get(home, 0) + 1
        return {replica: count / sample for replica, count in counts.items()}


class ReplicaHealth:
    """One replica's health state + transition log.

    The fleet's monitor owns the SIGNALS (heartbeat liveness, lane-depth /
    breaker / error-rate gauges); this class owns the legal transitions and
    the audit trail. ``transition()`` returns whether the state actually
    changed, so callers emit exactly one event per real change.
    """

    def __init__(self, replica_id: Hashable, clock: Callable[[], float] = time.monotonic) -> None:
        self.replica_id = replica_id
        self._clock = clock
        self.state = "healthy"
        self.reason = "start"
        self.since = clock()
        self.consecutive_heartbeat_misses = 0
        # recent transitions only — the durable audit trail is the
        # on_replica_health event stream; a flapping replica must not grow
        # process memory without bound
        self.transitions: List[Dict[str, Any]] = []
        self.transition_count = 0

    @property
    def takes_traffic(self) -> bool:
        """Whether the router may send NEW requests here (home traffic)."""
        return self.state in ("healthy", "degraded")

    @property
    def takes_failover(self) -> bool:
        """Whether rerouted/hedged traffic may land here. Stricter than
        :attr:`takes_traffic`: piling another replica's users onto an
        already-degraded one is how one failure becomes two."""
        return self.state == "healthy"

    def transition(self, to: str, reason: str = "") -> bool:
        """Move to ``to`` (returns False when already there); raises on a
        transition the state machine does not allow."""
        if to not in REPLICA_HEALTH:
            msg = f"unknown health state {to!r} (expected one of {REPLICA_HEALTH})"
            raise ValueError(msg)
        if to == self.state:
            return False
        if to not in _TRANSITIONS[self.state]:
            msg = (
                f"replica {self.replica_id!r}: illegal health transition "
                f"{self.state} -> {to} ({reason or 'no reason'})"
            )
            raise ValueError(msg)
        record = {
            "replica": self.replica_id,
            "from": self.state,
            "to": to,
            "reason": reason,
            "at": self._clock(),
        }
        self.state = to
        self.reason = reason
        self.since = record["at"]
        self.transitions.append(record)
        self.transition_count += 1
        if len(self.transitions) > 512:
            del self.transitions[:256]
        return True

    def snapshot(self) -> Dict[str, Any]:
        return {
            "replica": self.replica_id,
            "state": self.state,
            "reason": self.reason,
            "since": self.since,
            "heartbeat_misses": self.consecutive_heartbeat_misses,
            "transitions": self.transition_count,
        }


class BackoffPolicy:
    """Capped exponential backoff honoring the service's retry-after hint.

    ``delay(attempt)`` grows ``base * multiplier**attempt`` up to ``cap``;
    when the refusal carried a ``retry_after_s`` (the shed lane's own
    backlog-drain estimate), the delay is never SHORTER than that hint —
    retrying into a lane that told you when it will have room is the one
    retry pattern that cannot help.
    """

    def __init__(
        self,
        base_s: float = 0.01,
        multiplier: float = 2.0,
        cap_s: float = 1.0,
        max_retries: int = 2,
    ) -> None:
        if base_s < 0 or cap_s < 0 or multiplier < 1.0:
            msg = (
                f"backoff needs base_s>=0, cap_s>=0, multiplier>=1 "
                f"(got {base_s}, {cap_s}, {multiplier})"
            )
            raise ValueError(msg)
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.cap_s = float(cap_s)
        self.max_retries = int(max_retries)

    def delay(self, attempt: int, retry_after_s: Optional[float] = None) -> float:
        """Seconds to wait before retry number ``attempt`` (0-based)."""
        try:
            grown = self.base_s * self.multiplier ** max(int(attempt), 0)
        except OverflowError:
            # multiplier**attempt past float range (~2.0**1024): the growth is
            # monotonic, so the cap is the exact answer — never an exception
            # out of a retry scheduler
            grown = float("inf")
        backoff = min(grown, self.cap_s)
        if retry_after_s is not None:
            # the hint wins when it is LONGER; the cap still bounds the total
            backoff = min(max(backoff, float(retry_after_s)), max(self.cap_s, float(retry_after_s)))
        return backoff

    def exhausted(self, attempt: int) -> bool:
        return int(attempt) >= self.max_retries
