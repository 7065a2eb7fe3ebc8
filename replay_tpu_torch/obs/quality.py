"""Online recommendation-quality telemetry: the model-quality half of the
metrics plane (docs/observability.md "The quality plane").

Copied from ``replay_tpu/obs/quality.py`` (host-only: numpy-free, stdlib
only). The system half of the observability stack answers "is the service up,
fast, and alive"; this module answers "is the model still good" —
continuously, from live traffic, with no new hot-path hooks (a sink consuming
what the serving path already produces): the offline formulas of
``metrics/`` run on every served slate.

Three parts:

* **Response-side telemetry** — :class:`QualityMonitor` consumes served top-k
  cuts (``ScoreResponse`` via :func:`replay_tpu_torch.serve.request.top_k_cut`) into
  sliding-window, per-``role``-labeled gauges: catalog coverage, mean
  popularity (popularity bias), novelty and surprisal (the
  ``metrics/beyond_accuracy`` pure functions against a pure-JSON
  :class:`PopularityDescriptor` snapshot), popularity-decile intra-list
  diversity, and score-distribution stats (normalized softmax entropy, top-1
  margin). Stable vs canary quality is comparable in ONE scrape.
* **Streaming prequential eval** — a bounded per-user store of the last served
  slate is joined against incoming ``new_items`` interactions (every window
  advance is a delayed ground-truth label the serving path carries for free)
  producing online hitrate@k / MRR@k / NDCG@k — windowed AND cumulative — with
  exactly the ``metrics/ranking.py`` per-user formulas (reconciled to float
  tolerance in ``tests/_torch/test_torch_quality.py``).
* **Drift detection + gating** — :class:`DriftDetector` computes reference-vs-
  window PSI (population stability index) over the score / popularity /
  interactions (incoming-label popularity) / coverage series; the bridge exposes everything as ``replay_quality_*`` and
  ``replay_drift_*`` registry series (exporter + federation ride along), and
  the :data:`QUALITY_SLOS` cookbook rules make the ``SLOWatchdog`` fire the
  drift alarm exactly once per excursion and the ``PromotionController`` roll
  back a canary whose QUALITY (not just error rate) degrades
  (:func:`canary_quality_rules`).

Events: ``on_quality_window`` (one per role per emission window, INFO render)
and ``on_drift_warning`` (throttled like ``on_shed``) ride the normal RunLogger
sink fan-out via the owning service's ``_emit`` — ``obs.metrics.MetricsLogger``
bridges them into the registry.
"""

from __future__ import annotations

import json
import math
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Sequence, Tuple

from .slo import SLORule


def _beyond_accuracy():
    """Lazy seam to the offline per-slate math: ``replay_tpu_torch.metrics``'s
    package import is heavier than ``replay_tpu_torch.obs`` needs at import
    time — resolved on first observation instead."""
    from ..metrics import beyond_accuracy

    return beyond_accuracy

__all__ = [
    "DriftDetector",
    "PopularityDescriptor",
    "QUALITY_SLOS",
    "QualityMonitor",
    "canary_quality_rules",
    "population_stability_index",
    "prequential_scores",
]


# ---------------------------------------------------------------------------
# offline↔online shared math
# ---------------------------------------------------------------------------


def prequential_scores(
    slate: Sequence[int], ground_truth: Sequence[int], k: int
) -> Tuple[float, float, float]:
    """``(hit@k, rr@k, ndcg@k)`` of ONE served slate against ONE delayed
    ground-truth list — exactly the per-user formulas of
    ``metrics/ranking.py`` (:class:`~replay_tpu_torch.metrics.HitRate` /
    :class:`~replay_tpu_torch.metrics.MRR` / :class:`~replay_tpu_torch.metrics.NDCG`):
    hit = any relevant item in the top-k window; rr = 1/(first-hit rank);
    NDCG discounts 1/log2(rank+2) with IDCG truncating the RAW ground-truth
    length at k. Served slates are duplicate-free, so the occurrence/first-
    occurrence hit matrices coincide.
    """
    head = list(slate[:k])
    gt_list = list(ground_truth)
    if not head or not gt_list:
        return 0.0, 0.0, 0.0
    gt_set = set(gt_list)
    hit = 0.0
    rr = 0.0
    dcg = 0.0
    for rank, item in enumerate(head):
        if item in gt_set:
            hit = 1.0
            if rr == 0.0:
                rr = 1.0 / (rank + 1.0)
            dcg += 1.0 / math.log2(rank + 2.0)
    idcg = sum(1.0 / math.log2(i + 2.0) for i in range(min(len(gt_list), k)))
    ndcg = dcg / idcg if idcg > 0.0 else 0.0
    return hit, rr, ndcg


def population_stability_index(
    reference: Sequence[float],
    current: Sequence[float],
    edges: Sequence[float],
    epsilon: float = 1e-4,
) -> float:
    """PSI of ``current`` vs ``reference`` over shared bin ``edges``:
    ``sum((p_i - q_i) * ln(p_i / q_i))`` with epsilon-smoothed, renormalized
    bin fractions. Values outside the edge range clamp into the boundary bins
    (a shifted distribution lands in the tails instead of vanishing).
    Rule of thumb: < 0.1 stable · 0.1–0.25 moderate shift · > 0.25 major shift.
    """
    if not reference or not current or len(edges) < 2:
        return 0.0

    def _fractions(values: Sequence[float]) -> List[float]:
        counts = [0.0] * (len(edges) - 1)
        for value in values:
            lo, hi = 0, len(edges) - 2
            if value <= edges[0]:
                bin_index = 0
            elif value >= edges[-1]:
                bin_index = hi
            else:
                bin_index = lo
                while bin_index < hi and value > edges[bin_index + 1]:
                    bin_index += 1
            counts[bin_index] += 1.0
        total = sum(counts) + epsilon * len(counts)
        return [(c + epsilon) / total for c in counts]

    p = _fractions(reference)
    q = _fractions(current)
    return float(sum((pi - qi) * math.log(pi / qi) for pi, qi in zip(p, q)))


# ---------------------------------------------------------------------------
# the popularity snapshot (pure JSON)
# ---------------------------------------------------------------------------


class PopularityDescriptor:
    """A pure-JSON catalog-popularity snapshot the online monitor scores
    slates against — the frozen offline side of the offline↔online seam.

    Built once from a training/interactions log (``from_train``), it carries
    per-item distinct-consumer counts and derives exactly the
    ``metrics/beyond_accuracy`` quantities: surprisal weights
    (``log2(n_users/consumers)/log2(n_users)``, unseen → 1.0), popularity
    fractions (consumers / n_users) and popularity deciles (0 = head,
    9 = tail) used by the decile intra-list-diversity proxy. ``to_json`` /
    ``from_json`` round-trip it as a deployable artifact next to the model.
    """

    def __init__(self, consumers: Mapping[int, int], n_users: int, num_items: Optional[int] = None) -> None:
        self.consumers: Dict[int, int] = {int(i): int(c) for i, c in consumers.items() if int(c) > 0}
        self.n_users = int(n_users)
        self.num_items = int(num_items) if num_items is not None else (max(self.consumers) + 1 if self.consumers else 0)
        self.train_items = set(self.consumers)
        log_n = math.log2(self.n_users) if self.n_users > 1 else 1.0
        self._weights: Dict[int, float] = {
            item: math.log2(self.n_users / count) / log_n if self.n_users > 1 else 1.0
            for item, count in self.consumers.items()
        }
        denom = float(self.n_users) if self.n_users > 0 else 1.0
        self._popularity: Dict[int, float] = {item: count / denom for item, count in self.consumers.items()}
        # decile by popularity rank (count desc, item asc tiebreak): 0 = head
        ranked = sorted(self.consumers, key=lambda item: (-self.consumers[item], item))
        n = len(ranked)
        self._decile: Dict[int, int] = {item: min(9, (10 * rank) // n) for rank, item in enumerate(ranked)} if n else {}

    @classmethod
    def from_train(cls, train: Mapping[Any, Sequence[int]], num_items: Optional[int] = None) -> "PopularityDescriptor":
        """From a ``{user: [item, ...]}`` interactions log (the same input the
        offline Surprisal/Novelty/Coverage metrics take)."""
        consumers: Dict[int, set] = {}
        for user, items in train.items():
            for item in items:
                consumers.setdefault(int(item), set()).add(user)
        return cls({item: len(users) for item, users in consumers.items()}, len(train), num_items)

    def surprisal_weight(self, item: int) -> float:
        return self._weights.get(int(item), 1.0)

    def popularity(self, item: int) -> float:
        return self._popularity.get(int(item), 0.0)

    def decile(self, item: int) -> int:
        """Popularity decile (0 = most popular tenth, 9 = tail); unseen items
        are tail by definition."""
        return self._decile.get(int(item), 9)

    def to_json(self) -> str:
        return json.dumps(
            {
                "n_users": self.n_users,
                "num_items": self.num_items,
                "consumers": {str(i): c for i, c in sorted(self.consumers.items())},
            }
        )

    @classmethod
    def from_json(cls, payload: str) -> "PopularityDescriptor":
        record = json.loads(payload)
        return cls(
            {int(i): int(c) for i, c in record["consumers"].items()},
            int(record["n_users"]),
            int(record["num_items"]),
        )


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------


class DriftDetector:
    """Reference-vs-window PSI over one scalar series.

    The first ``reference_size`` observations freeze the reference histogram
    (uniform bins over the observed range, widened by a relative margin so
    near-boundary values don't flap bins); later observations fill a sliding
    window, and :meth:`psi` compares window vs reference once at least
    ``min_window`` samples arrived. Tuning levers: more ``bins`` = finer but
    noisier; a larger ``reference_size`` = a steadier baseline; a larger
    ``window`` = slower but surer detection.
    """

    def __init__(
        self,
        bins: int = 10,
        reference_size: int = 256,
        window: int = 256,
        min_window: int = 32,
        epsilon: float = 1e-4,
    ) -> None:
        if bins < 2:
            msg = "DriftDetector needs at least 2 bins"
            raise ValueError(msg)
        self.bins = int(bins)
        self.reference_size = int(reference_size)
        self.min_window = int(min_window)
        self.epsilon = float(epsilon)
        self._reference: List[float] = []
        self._edges: Optional[List[float]] = None
        self._window: Deque[float] = deque(maxlen=int(window))

    @property
    def ready(self) -> bool:
        return self._edges is not None and len(self._window) >= self.min_window

    def observe(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            return
        if self._edges is None:
            self._reference.append(value)
            if len(self._reference) >= self.reference_size:
                self._freeze()
            return
        self._window.append(value)

    def _freeze(self) -> None:
        lo, hi = min(self._reference), max(self._reference)
        span = (hi - lo) or max(abs(lo), 1.0) * 1e-6
        lo -= 0.05 * span
        hi += 0.05 * span
        step = (hi - lo) / self.bins
        self._edges = [lo + i * step for i in range(self.bins + 1)]

    def psi(self) -> Optional[float]:
        if not self.ready:
            return None
        return population_stability_index(
            self._reference, list(self._window), self._edges, self.epsilon
        )

    def state(self) -> Dict[str, Any]:
        return {
            "reference": len(self._reference),
            "window": len(self._window),
            "ready": self.ready,
            "psi": self.psi(),
        }


# ---------------------------------------------------------------------------
# SLO cookbook
# ---------------------------------------------------------------------------

#: Quality-plane SLO cookbook (docs/observability.md "The quality plane").
#: ``drift_psi`` is the preference-shift alarm — the watchdog's transition-fire
#: semantics make it fire EXACTLY once per sustained excursion; the ``canary_*``
#: rules gate the candidate traffic slice and belong in
#: ``PromotionController(rules=...)`` (see :func:`canary_quality_rules` for
#: tuned thresholds). Thresholds are cookbook defaults — tune per catalog.
QUALITY_SLOS: Tuple[SLORule, ...] = (
    SLORule("replay_drift_psi", ">", 0.25, for_steps=2, name="drift_psi"),
    SLORule(
        "replay_quality_online_hitrate",
        "<",
        0.01,
        for_steps=2,
        labels={"role": "candidate"},
        name="canary_online_hitrate",
    ),
    SLORule(
        "replay_quality_coverage",
        "<",
        0.005,
        for_steps=2,
        labels={"role": "candidate"},
        name="canary_coverage",
    ),
)


def canary_quality_rules(
    min_online_hitrate: Optional[float] = None,
    min_coverage: Optional[float] = None,
    min_novelty: Optional[float] = None,
    max_popularity: Optional[float] = None,
    for_steps: int = 2,
) -> Tuple[SLORule, ...]:
    """Quality rules over the CANDIDATE traffic slice, for
    ``PromotionController(rules=...)`` — a canary whose served quality drops
    below these floors (or whose popularity bias exceeds the cap) is rolled
    back even when its error rate and latency look healthy. Only the passed
    thresholds produce rules.
    """
    labels = {"role": "candidate"}
    rules: List[SLORule] = []
    if min_online_hitrate is not None:
        rules.append(
            SLORule(
                "replay_quality_online_hitrate", "<", float(min_online_hitrate),
                for_steps=for_steps, labels=labels, name="canary_online_hitrate",
            )
        )
    if min_coverage is not None:
        rules.append(
            SLORule(
                "replay_quality_coverage", "<", float(min_coverage),
                for_steps=for_steps, labels=labels, name="canary_coverage",
            )
        )
    if min_novelty is not None:
        rules.append(
            SLORule(
                "replay_quality_novelty", "<", float(min_novelty),
                for_steps=for_steps, labels=labels, name="canary_novelty",
            )
        )
    if max_popularity is not None:
        rules.append(
            SLORule(
                "replay_quality_popularity", ">", float(max_popularity),
                for_steps=for_steps, labels=labels, name="canary_popularity_bias",
            )
        )
    return tuple(rules)


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


class _RoleWindow:
    """Sliding-window quality state for one traffic role (stable/candidate)."""

    def __init__(self, window: int) -> None:
        self.requests = 0
        self.slates: Deque[Tuple[int, ...]] = deque(maxlen=window)
        self.novelty: Deque[float] = deque(maxlen=window)
        self.surprisal: Deque[float] = deque(maxlen=window)
        self.popularity: Deque[float] = deque(maxlen=window)
        self.ild: Deque[float] = deque(maxlen=window)
        self.entropy: Deque[float] = deque(maxlen=window)
        self.margin: Deque[float] = deque(maxlen=window)
        self.prequential: Deque[Tuple[float, float, float]] = deque(maxlen=window)
        self.joins = 0
        self.hit_sum = 0.0
        self.rr_sum = 0.0
        self.ndcg_sum = 0.0


def _mean(values) -> Optional[float]:
    values = list(values)
    if not values:
        return None
    return sum(values) / len(values)


class QualityMonitor:
    """Consumes served responses into windowed quality gauges, prequential
    online accuracy and drift detection — one ``observe()`` per response,
    thread-safe, never raising into the serving path (the owning service
    detaches a failing monitor).

    Attach via ``ScoringService(quality=QualityMonitor(descriptor))``; the
    service binds ``emit``/``emit_throttled`` so ``on_quality_window`` /
    ``on_drift_warning`` ride its sink fan-out (and, through
    ``MetricsLogger``, its registry/exporter/federation).
    """

    def __init__(
        self,
        descriptor: PopularityDescriptor,
        k: int = 10,
        window: int = 256,
        max_users: int = 10_000,
        emit_every: int = 64,
        drift_bins: int = 10,
        drift_reference: int = 256,
        drift_window: int = 256,
        drift_min_window: int = 32,
        drift_threshold: float = 0.25,
        max_seen_per_user: int = 512,
        emit: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        emit_throttled: Optional[Callable[[str, str, Dict[str, Any]], None]] = None,
    ) -> None:
        self.descriptor = descriptor
        self.k = int(k)
        self.window = int(window)
        self.max_users = int(max_users)
        self.emit_every = max(int(emit_every), 1)
        self.drift_threshold = float(drift_threshold)
        self.max_seen_per_user = int(max_seen_per_user)
        self._emit = emit
        self._emit_throttled = emit_throttled
        self._lock = threading.Lock()
        self._roles: "OrderedDict[str, _RoleWindow]" = OrderedDict()
        # bounded per-user state: last served slate (+ the role that served
        # it) for the prequential join, and the seen-items set for novelty
        self._last_slate: "OrderedDict[Any, Tuple[Tuple[int, ...], str]]" = OrderedDict()
        self._seen: "OrderedDict[Any, OrderedDict]" = OrderedDict()
        self._observed = 0
        self._since_emit = 0
        self._drift = {
            "score": DriftDetector(drift_bins, drift_reference, drift_window, drift_min_window),
            "popularity": DriftDetector(drift_bins, drift_reference, drift_window, drift_min_window),
            "interactions": DriftDetector(drift_bins, drift_reference, drift_window, drift_min_window),
            "coverage": DriftDetector(
                drift_bins,
                max(drift_reference // self.emit_every, 4),
                max(drift_window // self.emit_every, 4),
                max(drift_min_window // self.emit_every, 2),
            ),
        }
        self._drift_alarmed = False
        self.drift_warnings = 0
        self.windows_emitted = 0

    def bind(
        self,
        emit: Callable[[str, Dict[str, Any]], None],
        emit_throttled: Optional[Callable[[str, str, Dict[str, Any]], None]] = None,
    ) -> None:
        """Wire the monitor into an event fan-out (the owning service's
        ``_emit`` / ``_emit_throttled``)."""
        self._emit = emit
        self._emit_throttled = emit_throttled

    # -- per-response ingestion -------------------------------------------

    def observe(self, response, request=None) -> None:
        """Ingest one served response (and, when the paired request carried
        ``new_items``, the delayed ground-truth labels of that user's LAST
        served slate — the prequential join happens BEFORE the new slate is
        stored)."""
        from ..serve.request import top_k_cut  # lazy: obs must not import serve at module load

        item_ids, scores = top_k_cut(response, self.k)
        slate = tuple(int(i) for i in item_ids.tolist())
        score_list = [float(s) for s in scores.tolist()]
        role = str(getattr(response, "role", "stable") or "stable")
        user = response.user_id
        ground_truth = tuple(int(i) for i in (getattr(request, "new_items", None) or ()))
        history = tuple(int(i) for i in (getattr(request, "history", None) or ()))
        with self._lock:
            self._ingest(user, slate, score_list, role, ground_truth, history)
            emit_now = self._since_emit >= self.emit_every
            if emit_now:
                self._since_emit = 0
        if emit_now:
            self._emit_windows()

    def _ingest(
        self,
        user,
        slate: Tuple[int, ...],
        scores: List[float],
        role: str,
        ground_truth: Tuple[int, ...],
        history: Tuple[int, ...] = (),
    ) -> None:
        self._observed += 1
        self._since_emit += 1
        window = self._roles.get(role)
        if window is None:
            window = self._roles[role] = _RoleWindow(self.window)
        window.requests += 1

        # (1) prequential join: the user's PREVIOUS slate vs the labels that
        # just arrived — credited to the role that served that slate
        if ground_truth and user in self._last_slate:
            previous, previous_role = self._last_slate[user]
            prev_window = self._roles.get(previous_role)
            if prev_window is None:
                prev_window = self._roles[previous_role] = _RoleWindow(self.window)
            hit, rr, ndcg = prequential_scores(previous, ground_truth, self.k)
            prev_window.prequential.append((hit, rr, ndcg))
            prev_window.joins += 1
            prev_window.hit_sum += hit
            prev_window.rr_sum += rr
            prev_window.ndcg_sum += ndcg

        # (2) the user's seen set absorbs the interactions that PRECEDE this
        # slate (history refresh + the incremental tail), bounded LRU-style
        seen = self._seen.get(user)
        interactions = history + ground_truth
        if interactions:
            if seen is None:
                seen = self._seen[user] = OrderedDict()
            for item in interactions:
                seen[item] = None
                seen.move_to_end(item)
            while len(seen) > self.max_seen_per_user:
                seen.popitem(last=False)
            self._seen.move_to_end(user)
            while len(self._seen) > self.max_users:
                self._seen.popitem(last=False)

        # (3) response-side telemetry on the new slate
        pure = _beyond_accuracy()
        window.novelty.append(pure.novelty_of_slate(slate, seen or (), self.k))
        window.surprisal.append(
            pure.surprisal_of_slate(slate, self.descriptor._weights, self.k) if slate else 0.0
        )
        popularity = _mean(self.descriptor.popularity(item) for item in slate)
        window.popularity.append(popularity if popularity is not None else 0.0)
        window.ild.append(self._decile_ild(slate))
        entropy, margin = self._score_stats(scores)
        window.entropy.append(entropy)
        window.margin.append(margin)
        if slate:
            window.slates.append(slate)

        # (4) drift series (role-blind: the fleet-level preference signal).
        # "interactions" watches what users DO (incoming-label popularity —
        # the direct preference-shift signal); "score"/"popularity" watch what
        # the model serves in response; "coverage" is fed at emission cadence.
        if scores:
            self._drift["score"].observe(scores[0])
        if popularity is not None:
            self._drift["popularity"].observe(popularity)
        if ground_truth:
            label_popularity = _mean(
                self.descriptor.popularity(item) for item in ground_truth
            )
            if label_popularity is not None:
                self._drift["interactions"].observe(label_popularity)

        # (5) the last served slate, for the NEXT prequential join
        if slate:
            self._last_slate[user] = (slate, role)
            self._last_slate.move_to_end(user)
            while len(self._last_slate) > self.max_users:
                self._last_slate.popitem(last=False)

    def _decile_ild(self, slate: Tuple[int, ...]) -> float:
        """Popularity-decile intra-list diversity: the fraction of slate pairs
        whose items sit in DIFFERENT popularity deciles — 0.0 for a slate all
        drawn from one decile (pure head or pure tail), 1.0 for maximal
        head/tail mixing. A features-free ILD proxy the descriptor can score."""
        if len(slate) < 2:
            return 0.0
        deciles = [self.descriptor.decile(item) for item in slate]
        pairs = 0
        different = 0
        for i in range(len(deciles)):
            for j in range(i + 1, len(deciles)):
                pairs += 1
                if deciles[i] != deciles[j]:
                    different += 1
        return different / pairs

    @staticmethod
    def _score_stats(scores: List[float]) -> Tuple[float, float]:
        """(normalized softmax entropy, top-1 margin) of the slate's scores —
        a collapsing score distribution (entropy → 0, margin exploding) is an
        early model-rot signal independent of labels."""
        finite = [s for s in scores if math.isfinite(s)]
        if len(finite) < 2:
            return 0.0, 0.0
        top = max(finite)
        exps = [math.exp(s - top) for s in finite]
        total = sum(exps)
        probs = [e / total for e in exps]
        entropy = -sum(p * math.log(p) for p in probs if p > 0.0)
        entropy /= math.log(len(probs))
        ordered = sorted(finite, reverse=True)
        return entropy, ordered[0] - ordered[1]

    # -- window emission ---------------------------------------------------

    def _window_payload(self, role: str, window: _RoleWindow, drift: Dict[str, Any]) -> Dict[str, Any]:
        recommended = set()
        for slate in window.slates:
            recommended.update(slate)
        coverage = _beyond_accuracy().coverage_of(recommended, self.descriptor.train_items)
        preq = list(window.prequential)
        payload: Dict[str, Any] = {
            "role": role,
            "k": self.k,
            "requests": window.requests,
            "window": len(window.slates),
            "coverage": coverage,
            "novelty": _mean(window.novelty),
            "surprisal": _mean(window.surprisal),
            "popularity": _mean(window.popularity),
            "ild": _mean(window.ild),
            "score_entropy": _mean(window.entropy),
            "top1_margin": _mean(window.margin),
            "joins": window.joins,
            "online_hitrate": _mean(h for h, _, _ in preq),
            "online_mrr": _mean(rr for _, rr, _ in preq),
            "online_ndcg": _mean(n for _, _, n in preq),
            "online_hitrate_cum": window.hit_sum / window.joins if window.joins else None,
            "online_mrr_cum": window.rr_sum / window.joins if window.joins else None,
            "online_ndcg_cum": window.ndcg_sum / window.joins if window.joins else None,
            "drift": drift,
        }
        return payload

    #: the series the alarm (and the ``max`` entry, i.e. the
    #: ``replay_drift_psi`` gauge the SLO rules watch) is computed over:
    #: per-observation distributions with enough samples for PSI to mean
    #: something. "coverage" is fed ONE aggregate value per emitted window,
    #: so its PSI is dominated by traffic-mix and small-sample noise —
    #: surfaced in the series dict (and the ``replay_drift_psi_series``
    #: gauge) for dashboards, never part of the alarmed max.
    ALARMED_SERIES = ("score", "popularity", "interactions")

    def _drift_state(self) -> Dict[str, Any]:
        psis = {}
        for series, detector in self._drift.items():
            psi = detector.psi()
            if psi is not None:
                psis[series] = psi
        drift: Dict[str, Any] = dict(psis)
        alarmed = [psis[s] for s in self.ALARMED_SERIES if s in psis]
        if alarmed:
            drift["max"] = max(alarmed)
        return drift

    def _emit_windows(self) -> None:
        """Emit one ``on_quality_window`` per role (gauges land via the
        MetricsLogger bridge) and the drift alarm when PSI crosses the
        threshold — latched, so one excursion warns exactly once."""
        with self._lock:
            # coverage drift observes the stable window's coverage series at
            # emission cadence (coverage is a window property, not per-slate)
            stable = self._roles.get("stable")
            if stable is not None and stable.slates:
                recommended = set()
                for slate in stable.slates:
                    recommended.update(slate)
                self._drift["coverage"].observe(
                    _beyond_accuracy().coverage_of(recommended, self.descriptor.train_items)
                )
            drift = self._drift_state()
            payloads = [
                self._window_payload(role, window, drift)
                for role, window in self._roles.items()
                if window.requests
            ]
            self.windows_emitted += len(payloads)
            warn_payload = None
            psi_max = drift.get("max")
            if psi_max is not None and psi_max > self.drift_threshold:
                if not self._drift_alarmed:
                    self._drift_alarmed = True
                    self.drift_warnings += 1
                    series = max(
                        (s for s in self.ALARMED_SERIES if s in drift),
                        key=lambda s: drift[s],
                    )
                    warn_payload = {
                        "series": series,
                        "psi": drift[series],
                        "psi_max": psi_max,
                        "threshold": self.drift_threshold,
                    }
            elif psi_max is not None and psi_max <= 0.5 * self.drift_threshold:
                # hysteresis: re-arm at HALF the threshold, so a series
                # jittering at the boundary warns once per excursion rather
                # than once per wiggle
                self._drift_alarmed = False
        if self._emit is not None:
            for payload in payloads:
                self._emit("on_quality_window", payload)
            if warn_payload is not None:
                if self._emit_throttled is not None:
                    self._emit_throttled("drift", "on_drift_warning", warn_payload)
                else:
                    self._emit("on_drift_warning", warn_payload)

    def flush(self) -> None:
        """Emit the final (possibly partial) windows — called by the owning
        service at close so short runs still land their gauges."""
        with self._lock:
            pending = self._since_emit
            self._since_emit = 0
        if pending:
            self._emit_windows()

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Pure-JSON state for ``stats()`` / bench records / tests."""
        with self._lock:
            drift = self._drift_state()
            roles = {
                role: {
                    key: value
                    for key, value in self._window_payload(role, window, drift).items()
                    if key not in ("role", "drift")
                }
                for role, window in self._roles.items()
            }
            return {
                "observed": self._observed,
                "k": self.k,
                "windows_emitted": self.windows_emitted,
                "drift_warnings": self.drift_warnings,
                "drift": drift,
                "drift_state": {s: d.state() for s, d in self._drift.items()},
                "roles": roles,
            }
