"""Per-user encoded-state cache with LRU eviction.

Copied from ``replay_tpu/serve/cache.py`` (host numpy).

The serving-side answer to "returning users should not pay a full history
re-encode per request": the service caches, per user, the right-aligned item
window AND the encoder's last-position hidden state (the query embedding the
scoring head / MIPS retrieval consume). Request cost then depends on what
changed:

* nothing new → **pure hit**: the cached embedding is scored directly; the
  O(L·d²) transformer encode is skipped entirely.
* ``new_items`` → **advance**: the cached window rolls forward (one-step
  host-side state update; the client ships one event, not its history) and the
  canonical encode runs on the advanced window in a shared micro-batch —
  which is exactly why advanced scores stay BITWISE identical to a direct
  ``forward_inference`` of the updated history at the routed bucket (SASRec's
  positional table is tail-anchored, so appending shifts every position's
  embedding row; any "incremental" KV shortcut that skips re-attention would
  change the math, not just the bits).
* unknown user / explicit ``history`` → **cold**: full re-encode from the
  provided history (the exact-parity fallback), state inserted into the cache.

Thread-safe: client threads resolve states while the serve worker refreshes
embeddings after each encode.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, Optional, Sequence

import numpy as np

from .request import make_window


@dataclass
class UserState:
    """One user's cached serving state (window right-aligned to ``[L_max]``)."""

    window: np.ndarray  # [L_max] int32
    mask: np.ndarray  # [L_max] bool
    length: int  # valid events in the window (<= L_max)
    embedding: Optional[np.ndarray] = None  # [E] last-position hidden state
    generation: int = 0  # bumped on every advance/refresh (stale-write guard)
    # the PARAM generation whose encoder produced ``embedding`` (serve.promote
    # hot swaps): an embedding encoded by generation G must only ever be
    # scored by generation G's scorer — the service treats a mismatch as an
    # embedding miss and re-encodes, never mixing generations in one response
    param_generation: int = 0


class UserStateCache:
    """LRU map ``user_id -> UserState`` with hit/advance/eviction accounting."""

    def __init__(self, capacity: int = 10_000) -> None:
        if capacity <= 0:
            msg = "cache capacity must be positive"
            raise ValueError(msg)
        self.capacity = int(capacity)
        self._states: "OrderedDict[Hashable, UserState]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.advances = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def lookup(self, user_id: Hashable) -> Optional[UserState]:
        """The user's state (refreshing LRU recency), or None; counts the
        hit/miss either way."""
        with self._lock:
            state = self._states.get(user_id)
            if state is None:
                self.misses += 1
                return None
            self._states.move_to_end(user_id)
            self.hits += 1
            return state

    def peek(self, user_id: Hashable) -> Optional[UserState]:
        """Like :meth:`lookup` but with no recency/counter side effects."""
        with self._lock:
            return self._states.get(user_id)

    def store(self, user_id: Hashable, state: UserState) -> None:
        with self._lock:
            self._states[user_id] = state
            self._states.move_to_end(user_id)
            while len(self._states) > self.capacity:
                self._states.popitem(last=False)
                self.evictions += 1

    @staticmethod
    def _advanced(state: UserState, new_items: Sequence[int], pad_id: int) -> UserState:
        max_len = state.window.shape[0]
        valid = state.window[state.mask] if state.length else np.zeros(0, np.int32)
        items = np.concatenate([valid, np.asarray(new_items, np.int32)])
        window, mask, length = make_window(items, max_len, pad_id)
        return UserState(
            window=window,
            mask=mask,
            length=length,
            embedding=None,
            generation=state.generation + 1,
        )

    def advance(self, state: UserState, new_items: Sequence[int], pad_id: int = 0) -> UserState:
        """The one-step incremental update: append ``new_items`` to the cached
        window (rolling the oldest events out once full). The embedding is
        dropped — it certifies the PREVIOUS window; the serve worker refreshes
        it from the next canonical encode. Pure (does not touch the map) —
        :meth:`advance_user` is the atomic lookup+advance+store most callers
        want."""
        self.advances += 1
        return self._advanced(state, new_items, pad_id)

    def advance_user(
        self, user_id: Hashable, new_items: Sequence[int], pad_id: int = 0
    ) -> Optional[UserState]:
        """Atomically advance ``user_id``'s cached window by ``new_items`` and
        return the new state (None when the user is not cached). One lock
        acquisition covers lookup→advance→store: two clients appending
        concurrently both land their items instead of the last write erasing
        the other's interaction."""
        with self._lock:
            state = self._states.get(user_id)
            if state is None:
                self.misses += 1
                return None
            self.hits += 1
            self.advances += 1
            advanced = self._advanced(state, new_items, pad_id)
            self._states[user_id] = advanced
            self._states.move_to_end(user_id)
            return advanced

    def refresh_embedding(
        self,
        user_id: Hashable,
        state: UserState,
        embedding: np.ndarray,
        param_generation: int = 0,
    ) -> None:
        """Attach the just-encoded hidden state — unless the user advanced
        again while the batch was in flight (generation moved on), in which
        case the stale embedding must not overwrite the newer window's slot.
        Check and store happen under ONE lock acquisition, so an advance
        landing between them cannot be clobbered. ``param_generation`` stamps
        WHICH parameter generation encoded the state (the hot-swap staleness
        guard)."""
        with self._lock:
            current = self._states.get(user_id)
            if current is not None and current.generation > state.generation:
                return
            state.embedding = np.asarray(embedding)
            state.param_generation = int(param_generation)
            self._states[user_id] = state
            self._states.move_to_end(user_id)
            while len(self._states) > self.capacity:
                self._states.popitem(last=False)
                self.evictions += 1

    def stats(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        return {
            "size": len(self),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "advances": self.advances,
            "evictions": self.evictions,
            "hit_rate": self.hits / lookups if lookups else 0.0,
        }
