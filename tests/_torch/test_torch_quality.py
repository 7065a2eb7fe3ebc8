"""The port's quality plane and the scoring service's four planes against
the JAX package's, on the CPU.

* Every function of ``obs/quality.py`` on seeded inputs: ``prequential_scores``
  and ``population_stability_index`` equal to the bit, ``PopularityDescriptor``
  (its weights, popularity, deciles and JSON, read across packages),
  ``DriftDetector`` state after every observation, ``QUALITY_SLOS`` and
  ``canary_quality_rules``.
* A ``QualityMonitor`` in each package fed one response stream (two roles,
  delayed ground truth through ``new_items``, drift in the second half):
  the same events and the same snapshot, exactly.
* ``ScoringService(metrics_port=0, slo_rules=..., quality=..., flight_path=...)``
  in both packages on one weight tree and one request script: the same
  ``/metrics`` series with the same values (wall-clock series — rates, waits,
  uptime — excepted), the registry the port's bridge built byte-identical to
  a JAX ``MetricsLogger`` fed the port's own event stream, the same SLO
  events, the same flight-ring records and the same quality snapshot
  (scores at 1e-5, so the score-derived gauges at 1e-4).
"""

import json
import math
import urllib.request

import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.obs import blackbox as jax_blackbox
from replay_tpu.obs import metrics as jax_metrics
from replay_tpu.obs import quality as jax_quality
from replay_tpu.obs import slo as jax_slo
from replay_tpu.serve import request as jax_request
from replay_tpu.serve import FallbackScorer as JaxFallbackScorer
from replay_tpu.serve import ScoringService as JaxScoringService
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.obs import blackbox as port_blackbox
from replay_tpu_torch.obs import quality as port_quality
from replay_tpu_torch.obs import slo as port_slo
from replay_tpu_torch.serve import FallbackScorer, ScoringService
from replay_tpu_torch.serve import request as port_request

NUM_ITEMS, DIM, SEQ_LEN = 64, 8, 12
WAIT_S = 10.0
SCORE_TOL = 1e-5  # scores of one weight tree through the two packages
GAUGE_TOL = 1e-4  # gauges derived from those scores (entropy, margin, PSI)


# --------------------------------------------------------------------------- #
# the pure functions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 5, 10])
def test_prequential_scores_equal(seed, k):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        slate = rng.choice(50, size=int(rng.integers(0, 12)), replace=False).tolist()
        truth = rng.integers(0, 50, size=int(rng.integers(0, 6))).tolist()
        assert port_quality.prequential_scores(slate, truth, k) == jax_quality.prequential_scores(slate, truth, k)


PSI_CASES = {
    "same": (lambda r: r.normal(size=400), lambda r: r.normal(size=400)),
    "shifted": (lambda r: r.normal(size=400), lambda r: r.normal(1.5, size=400)),
    "outside_edges": (lambda r: r.uniform(0, 1, 300), lambda r: r.uniform(-3, 4, 300)),
    "constant": (lambda r: np.ones(50), lambda r: np.ones(20)),
    "empty": (lambda r: r.normal(size=10), lambda r: np.zeros(0)),
}


@pytest.mark.parametrize("case", sorted(PSI_CASES))
@pytest.mark.parametrize("epsilon", [1e-4, 1e-2])
def test_population_stability_index_equal(case, epsilon):
    rng = np.random.default_rng(3)
    ref, cur = (f(rng).tolist() for f in PSI_CASES[case])
    edges = np.linspace(-2, 2, 11).tolist()
    for bins in (edges, edges[:2], [0.0]):
        port = port_quality.population_stability_index(ref, cur, bins, epsilon)
        assert port == jax_quality.population_stability_index(ref, cur, bins, epsilon)


def _train(seed, users=200):
    rng = np.random.default_rng(seed)
    return {u: rng.zipf(1.4, size=int(rng.integers(1, 30))).clip(0, NUM_ITEMS - 1).tolist() for u in range(users)}


@pytest.mark.parametrize("seed", range(3))
def test_popularity_descriptor_equal_and_portable(seed):
    train = _train(seed)
    port = port_quality.PopularityDescriptor.from_train(train, num_items=NUM_ITEMS)
    jax = jax_quality.PopularityDescriptor.from_train(train, num_items=NUM_ITEMS)
    assert port.to_json() == jax.to_json()
    for item in range(NUM_ITEMS + 3):
        assert (port.surprisal_weight(item), port.popularity(item), port.decile(item)) == (
            jax.surprisal_weight(item), jax.popularity(item), jax.decile(item)
        )
    back = port_quality.PopularityDescriptor.from_json(jax.to_json())
    assert back.to_json() == port.to_json() and back.train_items == jax.train_items


@pytest.mark.parametrize("config", [dict(), dict(bins=4, reference_size=32, window=64, min_window=8),
                                    dict(bins=20, reference_size=100, window=50, min_window=50, epsilon=1e-2)])
def test_drift_detector_states_equal(config):
    rng = np.random.default_rng(11)
    stream = np.concatenate([rng.normal(size=300), rng.normal(0.8, 1.5, size=300), [np.nan, np.inf]])
    port, jax = port_quality.DriftDetector(**config), jax_quality.DriftDetector(**config)
    for value in stream:
        port.observe(value)
        jax.observe(value)
        assert port.state() == jax.state()
    assert port.ready and port.psi() > 0
    with pytest.raises(ValueError, match="at least 2 bins"):
        port_quality.DriftDetector(bins=1)


def _rule_fields(rules):
    return [(r.metric, r.op, r.threshold, r.for_steps, dict(r.labels or {}), r.name, r.label) for r in rules]


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(min_online_hitrate=0.05), dict(min_coverage=0.01, for_steps=1),
     dict(min_online_hitrate=0.1, min_coverage=0.02, min_novelty=0.3, max_popularity=0.4, for_steps=3)],
)
def test_quality_rules_equal(kwargs):
    assert _rule_fields(port_quality.canary_quality_rules(**kwargs)) == _rule_fields(
        jax_quality.canary_quality_rules(**kwargs)
    )
    assert _rule_fields(port_quality.QUALITY_SLOS) == _rule_fields(jax_quality.QUALITY_SLOS)


# --------------------------------------------------------------------------- #
# the monitor on one response stream
# --------------------------------------------------------------------------- #
def _stream(seed, full):
    """(response fields, request fields): top-k slates or full score rows,
    stable and candidate roles, and returning users whose ``new_items`` are
    the delayed labels of their last slate; popularity drifts half way."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(700):
        user = int(rng.integers(0, 60))
        shift = 2.0 if step > 350 else 0.0
        scores = rng.normal(shift, 1.0, size=NUM_ITEMS if full else 10).astype(np.float32)
        item_ids = None if full else rng.choice(NUM_ITEMS, size=10, replace=False).astype(np.int32)
        new_items = rng.integers(0, NUM_ITEMS, size=int(rng.integers(0, 3))).tolist() if step % 3 else []
        role = "candidate" if step % 5 == 0 else "stable"
        history = rng.integers(0, NUM_ITEMS, size=4).tolist() if step % 7 == 0 else None
        out.append((dict(user_id=user, scores=scores, item_ids=item_ids, role=role),
                    dict(user_id=user, history=history, new_items=tuple(new_items))))
    return out


def _monitor_run(quality, request, stream, **config):
    descriptor = quality.PopularityDescriptor.from_train(_train(0), num_items=NUM_ITEMS)
    events = []
    monitor = quality.QualityMonitor(
        descriptor, emit=lambda name, payload: events.append((name, payload)),
        emit_throttled=lambda key, name, payload: events.append((key, name, payload)), **config,
    )
    for response_fields, request_fields in stream:
        response = request.ScoreResponse(served_from="hit", lane="hit", queue_wait_s=0.0, **response_fields)
        monitor.observe(response, request.ScoreRequest(**request_fields))
    monitor.flush()
    return events, monitor.snapshot()


@pytest.mark.parametrize("full", [True, False], ids=["full_rows", "top_k"])
@pytest.mark.parametrize("config", [dict(), dict(k=5, window=64, emit_every=16, drift_reference=64, drift_window=64)],
                         ids=["defaults", "small_windows"])
def test_quality_monitor_events_and_snapshot_equal(full, config):
    stream = _stream(7, full)
    port = _monitor_run(port_quality, port_request, stream, **config)
    jax = _monitor_run(jax_quality, jax_request, stream, **config)
    assert port == jax
    events, snapshot = port
    assert snapshot["observed"] == len(stream) and set(snapshot["roles"]) == {"stable", "candidate"}
    assert snapshot["roles"]["stable"]["joins"] > 0 and any(e[0] == "on_quality_window" for e in events)


# --------------------------------------------------------------------------- #
# the service's four planes, both packages, one request script
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def weights():
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    width = dict(embedding_dim=DIM, num_blocks=1, num_heads=1, max_sequence_length=SEQ_LEN, dropout_rate=0.0)
    port_model = SasRec(schema, use_flash=True, device="cpu", generator=torch.Generator().manual_seed(1), **width)
    jax_schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return port_model, JaxSasRec(schema=jax_schema, use_flash=True, **width), torch_to_flax(port_model.state_dict())


class Events:
    def __init__(self):
        self.events = []

    def log_event(self, event):
        self.events.append(event)


def _script():
    rng = np.random.default_rng(21)
    histories = {u: rng.integers(0, NUM_ITEMS, size=int(rng.integers(1, 2 * SEQ_LEN))).tolist() for u in range(12)}
    requests = [(u, {"history": h}) for u, h in histories.items()]
    for _ in range(36):
        user = int(rng.integers(0, 12))
        if rng.random() < 0.5:
            requests.append((user, {"new_items": [int(rng.integers(0, NUM_ITEMS))]}))
        else:
            requests.append((user, {}))
    requests.append((99, {}))  # cold: the fallback floor
    return requests


def _scrape(url):
    with urllib.request.urlopen(f"{url}/metrics", timeout=WAIT_S) as reply:
        text = reply.read().decode()
    series = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            series[key] = float(value)
    return text, series


# series whose values are wall-clock readings (or summaries of them)
_TIMED = ("qps", "queue_wait", "uptime", "seconds", "_ms", "latency", "start_time")


def _close(a, b, tol):
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=tol, abs_tol=tol) or (math.isnan(a) and math.isnan(b))
    return a == b


def _planes(package, weights, tmp_path):
    port_model, jax_model, params = weights
    quality = port_quality if package == "port" else jax_quality
    slo = port_slo if package == "port" else jax_slo
    popularity = np.random.default_rng(0).integers(0, NUM_ITEMS, size=2048)
    descriptor = quality.PopularityDescriptor.from_train(_train(0), num_items=NUM_ITEMS)
    rules = [
        slo.SLORule("replay_serve_rows_total", ">", 20.0, name="rows"),
        slo.SLORule("replay_serve_degraded_total", ">", 0.0, labels={"to": "fallback"}, name="fallbacks"),
    ]
    events = Events()
    kwargs = dict(
        batch_buckets=(1, 8), max_wait_ms=1.0, cold_miss="fallback", logger=events, metrics_port=0,
        slo_rules=rules, quality=quality.QualityMonitor(descriptor, emit_every=8, drift_reference=16,
                                                        drift_window=16, drift_min_window=4),
        flight_path=str(tmp_path / f"flight.{package}.ring"),
    )
    if package == "port":
        service = ScoringService(port_model, flax_to_torch(params), device="cpu",
                                 fallback=FallbackScorer.from_interactions(popularity, NUM_ITEMS), **kwargs)
    else:
        service = JaxScoringService(jax_model, params, fallback=JaxFallbackScorer.from_interactions(popularity, NUM_ITEMS),
                                    **kwargs)
    with service:
        responses = [service.score(user, timeout=WAIT_S, **request) for user, request in _script()]
        text, series = _scrape(service.metrics_exporter.url)
        stats = service.stats()
    ring = (port_blackbox if package == "port" else jax_blackbox).read_flight(kwargs["flight_path"])
    return dict(responses=responses, text=text, series=series, events=events.events, stats=stats, ring=ring,
                registry=service.metrics_registry)


def test_the_four_planes_equal_jax(weights, tmp_path):
    port, jax = _planes("port", weights, tmp_path), _planes("jax", weights, tmp_path)
    for p, j in zip(port["responses"], jax["responses"]):
        np.testing.assert_allclose(p.scores, j.scores, atol=SCORE_TOL, rtol=SCORE_TOL)
        assert (p.served_from, p.served_by) == (j.served_from, j.served_by)
    # /metrics: the same series; the same values but for the wall-clock ones
    assert port["series"].keys() == jax["series"].keys()
    for key, value in port["series"].items():
        if not any(word in key for word in _TIMED):
            assert math.isclose(value, jax["series"][key], rel_tol=GAUGE_TOL, abs_tol=GAUGE_TOL), key
    # every request but the cold one (answered by the fallback floor) rode a batch
    assert port["series"]["replay_serve_rows_total"] == len(_script()) - 1
    # the bridge: the port's registry is what the JAX MetricsLogger makes of
    # the port's own events, byte for byte but for the qps gauge, which the
    # bridge reads off the wall clock as events arrive, and the SLO series,
    # which the watchdog writes; those match the JAX service's exactly
    replay = jax_metrics.MetricsLogger()
    for event in port["events"]:
        replay.log_event(event)

    def lines(text, slo):
        return [line for line in text.splitlines() if "replay_serve_qps" not in line and ("replay_slo_" in line) == slo]

    port_text = port["registry"].render_prometheus()
    assert lines(replay.registry.render_prometheus(), False) == lines(port_text, False)
    assert lines(port_text, True) == lines(jax["registry"].render_prometheus(), True) != []
    # the event streams and the SLO events
    names = [e.event for e in port["events"]]
    assert names == [e.event for e in jax["events"]]
    violations = [(e.payload["rule"], e.payload["value"]) for e in port["events"] if e.event == "on_slo_violation"]
    assert violations == [(e.payload["rule"], e.payload["value"]) for e in jax["events"] if e.event == "on_slo_violation"]
    assert {rule for rule, _ in violations} == {"rows", "fallbacks"}
    # the flight rings hold the same records, timestamps aside
    strip = lambda records: [{k: v for k, v in r.items() if k not in ("t", "time", "pid")} for r in records]  # noqa: E731
    port_records, jax_records = strip(port["ring"].records), strip(jax["ring"].records)
    assert [r.get("event") for r in port_records] == [r.get("event") for r in jax_records]
    assert port_records[-1]["event"] == "on_serve_end"
    # the quality plane: the same snapshot, score-derived gauges at 1e-4
    assert port["stats"]["quality"]["observed"] == len(_script())
    assert _close(port["stats"]["quality"], jax["stats"]["quality"], GAUGE_TOL)


def test_a_raising_quality_monitor_detaches(weights):
    port_model, _, params = weights

    class Broken:
        def bind(self, emit, emit_throttled=None):
            pass

        def observe(self, response, request=None):
            raise ValueError("monitor broke")

    service = ScoringService(port_model, flax_to_torch(params), device="cpu", batch_buckets=(1,), quality=Broken())
    with service:
        first = service.score(1, history=[1, 2, 3], timeout=WAIT_S)
        assert service.quality is None and service.stats()["quality"] is None
        second = service.score(1, timeout=WAIT_S)
    np.testing.assert_array_equal(first.scores, second.scores)
    assert json.dumps(service.stats()["served_by"]) == json.dumps({"primary": 2, "cache_only": 0, "fallback": 0})
