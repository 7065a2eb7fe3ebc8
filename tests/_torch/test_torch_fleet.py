"""The port's serving fleet against the JAX package's, on the CPU.

* The routing primitives (``serve/router.py``): ``HashRing`` owners for
  10,000 ids across an add and a remove, ``ReplicaHealth`` on scripted
  transition sequences, ``BackoffPolicy`` delays — equal across packages.
* ``ServingFleet`` over scripted stand-in replicas (the ``submit/heartbeat/
  stats/start/close`` surface the fleet duck-types over), health driven by
  ``poll()``: failover, degradation from the replicas' own gauges, shed
  retries with backoff, refusals of non-idempotent requests, drains and
  rolling swaps, hedges, and the no-healthy refusal give the same outcomes,
  stats and events in both packages.
* ``PromotionController`` on one scripted counter series: the same stages,
  decisions and events, a breach and a quality breach included.
* Two-replica fleets of the demo-size SASRec (L=12, D=8, 1 block, 64 items)
  in each package from one param tree (drawn by the port from a seed and
  carried to JAX by ``convert.torch_to_flax``): the same users on the same
  replica ids, scores within 1e-5 (atol and rtol), and failover after
  ``close()`` of one replica serving through the fallback in both.

Every wait is bounded, and every fleet is closed in a ``finally``.
"""

import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.obs import quality as jax_quality
from replay_tpu.serve import errors as jax_errors
from replay_tpu.serve import fleet as jax_fleet
from replay_tpu.serve import promote as jax_promote
from replay_tpu.serve import request as jax_request
from replay_tpu.serve import router as jax_router
from replay_tpu.serve import FallbackScorer as JaxFallbackScorer
from replay_tpu.serve import ScoringService as JaxScoringService
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.obs import quality as port_quality
from replay_tpu_torch.ops import counts
from replay_tpu_torch.serve import FallbackScorer, ScoringEngine, ScoringService
from replay_tpu_torch.serve import errors as port_errors
from replay_tpu_torch.serve import fleet as port_fleet
from replay_tpu_torch.serve import promote as port_promote
from replay_tpu_torch.serve import request as port_request
from replay_tpu_torch.serve import router as port_router

PACKAGES = {
    "jax": dict(router=jax_router, fleet=jax_fleet, errors=jax_errors, request=jax_request,
                promote=jax_promote, quality=jax_quality),
    "port": dict(router=port_router, fleet=port_fleet, errors=port_errors, request=port_request,
                 promote=port_promote, quality=port_quality),
}
WAIT_S = 10.0
NUM_ITEMS, DIM, SEQ_LEN = 64, 8, 12
ATOL = RTOL = 1e-5


# --------------------------------------------------------------------------- #
# routing primitives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("vnodes", [1, 8, 64, 160])
@pytest.mark.parametrize("keys", ["int", "str", "tuple"])
def test_hash_ring_owners_equal_across_add_and_remove(vnodes, keys):
    ids = {
        "int": list(range(10_000)),
        "str": [f"user-{i}" for i in range(10_000)],
        "tuple": [("u", i) for i in range(10_000)],
    }[keys]
    rings = {name: mods["router"].HashRing(("r0", "r1", "r2"), vnodes=vnodes) for name, mods in PACKAGES.items()}

    def owners():
        return {name: [ring.route(i) for i in ids] for name, ring in rings.items()}

    steps = []
    for change in (None, ("add", "r3"), ("remove", "r1"), ("add", "r1")):
        if change is not None:
            for ring in rings.values():
                getattr(ring, change[0])(change[1])
        seen = owners()
        assert seen["port"] == seen["jax"], change
        assert rings["port"].preference(ids[7]) == rings["jax"].preference(ids[7])
        steps.append(seen["port"])
    # adding r3 moved users only onto r3; removing r1 moved only r1's users
    assert all(after in (before, "r3") for before, after in zip(steps[0], steps[1]))
    assert all(after == before for before, after in zip(steps[1], steps[2]) if before != "r1")
    assert steps[3] == steps[1]
    assert rings["port"].spread(2000) == rings["jax"].spread(2000)


HEALTH_SCRIPTS = {
    "lifecycle": [("degraded", "lane_depth"), ("draining", "drain"), ("healthy", "rejoin"),
                  ("dead", "heartbeat"), ("healthy", "revived")],
    "repeats": [("healthy", "again"), ("degraded", "breaker_open"), ("degraded", "again"),
                ("healthy", "recovered")],
    "illegal": [("dead", "heartbeat"), ("degraded", "nope"), ("draining", "drain"), ("zombie", ""),
                ("healthy", "revived")],
    "flapping": [("degraded", "error_rate"), ("healthy", "recovered")] * 300,
}


@pytest.mark.parametrize("script", sorted(HEALTH_SCRIPTS))
def test_replica_health_transitions_equal(script):
    def run(router):
        ticks = iter(range(10_000))
        health = router.ReplicaHealth("r0", clock=lambda: float(next(ticks)))
        log = []
        for to, reason in HEALTH_SCRIPTS[script]:
            try:
                changed = health.transition(to, reason)
                log.append(("ok", changed, health.takes_traffic, health.takes_failover))
            except ValueError as exc:
                log.append(("refused", str(exc)))
        return log, health.transitions, health.snapshot()

    assert run(port_router) == run(jax_router)


@pytest.mark.parametrize(
    "config",
    [dict(), dict(base_s=0.01, multiplier=2.0, cap_s=0.05, max_retries=3),
     dict(base_s=0.001, multiplier=3.0, cap_s=1.0, max_retries=0), dict(base_s=0.0, multiplier=1.0, cap_s=0.0)],
    ids=["defaults", "capped", "steep", "zero"],
)
def test_backoff_delays_equal(config):
    hints = (None, 0.0, 0.001, 0.02, 0.25, 5.0)
    port, jax = port_router.BackoffPolicy(**config), jax_router.BackoffPolicy(**config)
    for attempt in (0, 1, 2, 3, 7, 12, 2000):
        assert port.exhausted(attempt) == jax.exhausted(attempt)
        for hint in hints:
            assert port.delay(attempt, retry_after_s=hint) == jax.delay(attempt, retry_after_s=hint)
    with pytest.raises(ValueError, match="backoff needs"):
        port_router.BackoffPolicy(multiplier=0.5)


# --------------------------------------------------------------------------- #
# the fleet over scripted stand-in replicas
# --------------------------------------------------------------------------- #
class EventLog:
    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def log_event(self, event):
        with self._lock:
            self.events.append((event.event, dict(event.payload)))


class StandIn:
    """A replica with the fleet's duck-typed surface: answers (after
    ``delay_s``), sheds its first ``shed_first`` submits, refuses
    everything when ``refuse`` names an error, and reports the heartbeat
    gauges it is given."""

    def __init__(self, mods, name, delay_s=0.0, shed_first=0, refuse=None):
        self.mods = mods
        self.name = name
        self.delay_s = delay_s
        self.shed_remaining = shed_first
        self.refuse = refuse
        self.alive = True
        self.gauges = {"breaker_state": "closed", "queued": 0, "max_depth": 16, "errors": 0}
        self.submits = 0
        self.published = []
        self.batcher = self
        self.idle = True

    def start(self):
        self.alive = True
        return self

    def close(self):
        self.alive = False

    def heartbeat(self):
        if not self.alive:
            raise RuntimeError(f"{self.name} is down")
        return {"live": True, "requests": self.submits, **self.gauges}

    def stats(self):
        return {"submits": self.submits}

    def publish_candidate(self, params, label="", pipeline=None):
        self.published.append(label)
        return len(self.published)

    def promote(self, generation):
        return {"to_generation": generation}

    def submit(self, user_id, **kwargs):
        self.submits += 1
        future = Future()
        errors = self.mods["errors"]
        if not self.alive:
            future.set_exception(errors.ServiceClosed())
            return future
        if self.shed_remaining > 0 or self.refuse == "shed":
            self.shed_remaining -= 1
            future.set_exception(errors.RequestShed(("encode", 1), 16, 16, retry_after_s=0.02))
            return future
        if self.refuse == "error":
            future.set_exception(RuntimeError(f"{self.name} broke"))
            return future

        def resolve():
            if future.set_running_or_notify_cancel():
                future.set_result(self.mods["request"].ScoreResponse(
                    user_id=user_id, scores=np.full(3, float(self.submits)), item_ids=None,
                    served_from="hit", lane="hit", queue_wait_s=0.0,
                ))

        if self.delay_s:
            timer = threading.Timer(self.delay_s, resolve)
            timer.daemon = True
            timer.start()
        else:
            resolve()
        return future


def _outcome(future):
    try:
        response = future.result(timeout=WAIT_S)
    except Exception as exc:  # noqa: BLE001 — the refusal is the outcome
        return ("error", type(exc).__name__)
    return ("answer", response.replica, response.served_from)


def _homed(fleet, replica, count=5):
    return [user for user in range(1000) if fleet.ring.route(user) == replica][:count]


def _stable_stats(stats):
    """The fleet's stats without the wall-clock latency fields."""
    out = {k: v for k, v in stats.items() if k not in ("p50_ms", "p99_ms", "latency_exemplars")}
    return out


def scenario_failover(mods, fleet, replicas):
    victim = _homed(fleet, "r1")
    before = [_outcome(fleet.submit(u)) for u in victim]
    replicas["r1"].close()
    for _ in range(3):
        fleet.poll()
    during = [_outcome(fleet.submit(u)) for u in victim]
    replicas["r1"].start()
    fleet.poll()
    after = [_outcome(fleet.submit(u)) for u in victim]
    return before, during, after, fleet.health()


def scenario_degrade(mods, fleet, replicas):
    states = []
    for gauges in ({"breaker_state": "open"}, {"breaker_state": "closed"}, {"queued": 13},
                   {"queued": 0}, {"errors": 0}):
        replicas["r0"].gauges.update(gauges)
        fleet.poll()
        states.append(fleet.health())
    replicas["r2"].gauges["errors"] = 100
    replicas["r2"].submits += 20
    fleet.poll()
    states.append(fleet.health())
    # a degraded home still takes its own users; failover skips it
    homed = [_outcome(fleet.submit(u)) for u in _homed(fleet, "r2")]
    return states, homed


def scenario_shed_retry(mods, fleet, replicas):
    replicas["r0"].shed_remaining = 2
    idempotent = [_outcome(fleet.submit(u)) for u in _homed(fleet, "r0", 2)]
    replicas["r0"].shed_remaining = 1
    mutating = _outcome(fleet.submit(_homed(fleet, "r0", 1)[0], new_items=[3]))
    replicas["r0"].refuse = replicas["r1"].refuse = replicas["r2"].refuse = "shed"
    exhausted = _outcome(fleet.submit(0))
    replicas["r0"].refuse = "error"
    replicas["r1"].refuse = replicas["r2"].refuse = None
    broken = [_outcome(fleet.submit(u)) for u in _homed(fleet, "r0", 2)]
    return idempotent, mutating, exhausted, broken


def scenario_drain_swap(mods, fleet, replicas):
    assert fleet.drain("r0", timeout_s=1.0)
    drained = [_outcome(fleet.submit(u)) for u in _homed(fleet, "r0")]
    fleet.rejoin("r0")
    replicas["r2"].close()
    for _ in range(3):
        fleet.poll()
    results = fleet.rolling_swap({"w": 1}, label="rollout")
    published = {rid: r.published for rid, r in replicas.items()}
    return drained, results, published, fleet.health()


def scenario_hedge(mods, fleet, replicas):
    replicas["r0"].delay_s = 0.5
    outcomes = [_outcome(fleet.submit(u)) for u in _homed(fleet, "r0", 3)]
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and fleet.stats()["hedge_cancelled"] < 3:
        time.sleep(0.01)
    return outcomes


def scenario_no_healthy(mods, fleet, replicas):
    for replica in replicas.values():
        replica.close()
    for _ in range(3):
        fleet.poll()
    future = fleet.submit(1)
    try:
        future.result(timeout=WAIT_S)
    except mods["errors"].NoHealthyReplica as exc:
        return sorted(exc.replicas), fleet.health()
    raise AssertionError("no NoHealthyReplica")


SCENARIOS = {
    "failover": (scenario_failover, dict(hedge_ms=0)),
    "degrade": (scenario_degrade, dict(hedge_ms=0)),
    "shed_retry": (scenario_shed_retry, dict(hedge_ms=0)),
    "drain_swap": (scenario_drain_swap, dict(hedge_ms=0)),
    "hedge": (scenario_hedge, dict(hedge_ms=20)),
    "no_healthy": (scenario_no_healthy, dict(hedge_ms=0)),
}


def _run_scenario(name, package):
    mods = PACKAGES[package]
    body, kwargs = SCENARIOS[name]
    replicas = {f"r{i}": StandIn(mods, f"r{i}") for i in range(3)}
    log = EventLog()
    fleet = mods["fleet"].ServingFleet(
        replicas, heartbeat_interval_s=None, logger=log,
        backoff=mods["router"].BackoffPolicy(base_s=0.001, cap_s=0.05), **kwargs,
    )
    fleet.start()
    try:
        result = body(mods, fleet, replicas)
    finally:
        fleet.close()
    events = [(name, payload) for name, payload in log.events if name not in ("on_fleet_end",)]
    end = [payload for name, payload in log.events if name == "on_fleet_end"]
    return result, _stable_stats(fleet.stats()), events, _stable_stats(end[0])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_scenarios_equal_jax(name):
    port = _run_scenario(name, "port")
    jax = _run_scenario(name, "jax")
    assert port == jax
    result, stats = port[0], port[1]
    assert stats["requests"] > 0
    if name == "failover":
        before, during, after, health = result
        assert {o[1] for o in before} == {"r1"} and "r1" not in {o[1] for o in during}
        assert {o[1] for o in after} == {"r1"} and health["r1"] == "healthy"
    if name == "hedge":
        assert stats["hedges"] == 3 and stats["hedge_wins"] == 3 and stats["hedge_cancelled"] == 3


# --------------------------------------------------------------------------- #
# PromotionController
# --------------------------------------------------------------------------- #
class ControlledService:
    """What PromotionController drives: publish/begin_canary/promote/rollback,
    canary_stats from a scripted series, and the event fan-out."""

    def __init__(self, mods, series, quality=None):
        self.mods = mods
        self.series = iter(series)
        self.metrics_registry = None
        self.quality = quality
        self.events = []
        self.generation = 0
        self.candidate = None

    def _route_event(self, event):
        self.events.append((event.event, dict(event.payload)))

    def _emit(self, event, payload):
        self.events.append((event, dict(payload)))

    def publish_candidate(self, params, label="", pipeline=None):
        self.candidate = self.generation + 1 + len(self.events)
        return self.candidate

    def begin_canary(self, generation, fraction):
        self.events.append(("begin_canary", {"generation": generation, "fraction": fraction}))

    def promote(self, generation):
        previous, self.generation = self.generation, generation
        return {"from_generation": previous, "to_generation": generation}

    def rollback(self):
        return {"from_generation": self.candidate, "to_generation": self.generation}

    def canary_stats(self):
        return {"candidate": next(self.series)}


def _counters(rows):
    totals = {"requests": 0.0, "answered": 0.0, "errors": 0.0, "shed": 0.0}
    out = []
    for row in rows:
        for key, value in row.items():
            totals[key] += value
        out.append({**totals, "queue_wait_ms_max": 3.0})
    return out


PROMOTION_SERIES = {
    "promoted": _counters([dict(requests=10, answered=10)] * 4),
    "breach": _counters([dict(requests=10, answered=10), dict(requests=10, answered=8, errors=2),
                         dict(requests=10, answered=10)]),
    "idle_windows": _counters([dict(), dict(requests=5, answered=5), dict(), dict(requests=5, answered=5),
                               dict(requests=5, answered=5)]),
    "quality_breach": _counters([dict(requests=10, answered=10)] * 5),
}


class StubQuality:
    def snapshot(self):
        return {"roles": {"candidate": {"joins": 4, "online_hitrate_cum": 0.0, "coverage": 0.001}}}


@pytest.mark.parametrize("series", sorted(PROMOTION_SERIES))
def test_promotion_controller_stages_equal(series):
    def run(mods):
        quality = series == "quality_breach"
        service = ControlledService(mods, PROMOTION_SERIES[series], quality=StubQuality() if quality else None)
        ticks = iter(range(1000))
        rules = mods["quality"].canary_quality_rules(min_online_hitrate=0.05, min_coverage=0.01) if quality else None
        controller = mods["promote"].PromotionController(
            service, rules=rules, promote_after=3, clock=lambda: float(next(ticks)),
        )
        stages = [controller.stage]
        controller.publish({"w": 1}, label="cand")
        stages.append(controller.stage)
        with pytest.raises(RuntimeError, match="begin_canary from stage"):
            mods["promote"].PromotionController(service).begin_canary()
        controller.begin_canary(0.25)
        stages.append(controller.stage)
        records = []
        for step in range(len(PROMOTION_SERIES[series])):
            if quality:
                for name, value in (("replay_quality_online_hitrate", 0.0), ("replay_quality_coverage", 0.001)):
                    controller.registry.set(name, value, labels={"role": "candidate"})
            records.append(controller.evaluate(step))
            stages.append(controller.stage)
            if controller.stage != "canary":
                break
        if controller.stage == "rolled_back":
            with pytest.raises(RuntimeError, match="begin_canary"):
                controller.begin_canary()
        return stages, records, service.events, controller.stats(), controller.registry.render_prometheus()

    port, jax = run(PACKAGES["port"]), run(PACKAGES["jax"])
    assert port == jax
    assert port[0][-1] == {"promoted": "promoted", "breach": "rolled_back", "idle_windows": "promoted",
                           "quality_breach": "rolled_back"}[series]
    assert port_promote.PROMOTION_STAGES == jax_promote.PROMOTION_STAGES


# --------------------------------------------------------------------------- #
# fleets of real replicas, one param tree
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    port_schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    width = dict(embedding_dim=DIM, num_blocks=1, num_heads=1, max_sequence_length=SEQ_LEN, dropout_rate=0.0)
    port_model = SasRec(port_schema, use_flash=True, device="cpu", generator=torch.Generator().manual_seed(0), **width)
    params = torch_to_flax(port_model.state_dict())
    jax_schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    jax_model = JaxSasRec(schema=jax_schema, use_flash=True, **width)
    popularity = np.random.default_rng(0).integers(0, NUM_ITEMS, size=2048)
    return port_model, jax_model, params, popularity


def _fleets(models):
    port_model, jax_model, params, popularity = models
    kwargs = dict(batch_buckets=(1, 8), max_wait_ms=2.0, cache_capacity=512, cold_miss="fallback")
    port = {
        f"r{i}": ScoringService(port_model, flax_to_torch(params), device="cpu",
                                fallback=FallbackScorer.from_interactions(popularity, NUM_ITEMS), **kwargs)
        for i in range(2)
    }
    jax = {
        f"r{i}": JaxScoringService(jax_model, params, fallback=JaxFallbackScorer.from_interactions(popularity, NUM_ITEMS),
                                   **kwargs)
        for i in range(2)
    }
    return (port_fleet.ServingFleet(port, heartbeat_interval_s=None, hedge_ms=0),
            jax_fleet.ServingFleet(jax, heartbeat_interval_s=None, hedge_ms=0))


def _histories():
    rng = np.random.default_rng(5)
    return {user: rng.integers(0, NUM_ITEMS, size=int(rng.integers(1, 2 * SEQ_LEN))).tolist() for user in range(24)}


def _answers(fleet, requests):
    return [fleet.score(user, timeout=WAIT_S, **kwargs) for user, kwargs in requests]


def test_real_fleets_route_and_score_alike_then_fail_over_to_the_fallback(models):
    histories = _histories()
    rng = np.random.default_rng(9)
    requests = [(user, {"history": history}) for user, history in histories.items()]
    requests += [(int(user), {}) for user in rng.integers(0, len(histories), 16)]
    requests += [(int(user), {"new_items": [int(rng.integers(0, NUM_ITEMS))]}) for user in rng.integers(0, len(histories), 8)]
    fleets = _fleets(models)
    try:
        for fleet in fleets:
            fleet.start()
        port, jax = (_answers(fleet, requests) for fleet in fleets)
        assert [r.replica for r in port] == [r.replica for r in jax]
        assert {r.replica for r in port} == {"r0", "r1"}
        for p, j in zip(port, jax):
            np.testing.assert_allclose(p.scores, j.scores, atol=ATOL, rtol=RTOL)
            assert (p.served_from, p.served_by, p.batch_bucket) == (j.served_from, j.served_by, j.batch_bucket)
        # failover: r0 closes, three missed heartbeats declare it dead, and
        # its users' next requests land cold on r1 and ride the fallback
        victims = [user for user in histories if fleets[0].ring.route(user) == "r0"][:4]
        assert victims and victims == [user for user in histories if fleets[1].ring.route(user) == "r0"][:4]
        outcomes = []
        for fleet in fleets:
            fleet.handles["r0"].service.close()
            for _ in range(3):
                fleet.poll()
            assert fleet.health() == {"r0": "dead", "r1": "healthy"}
            answers = _answers(fleet, [(user, {}) for user in victims])
            try:
                fleet.score(victims[0], timeout=WAIT_S, new_items=[1])
                refused = None
            except KeyError as exc:
                refused = type(exc).__name__
            outcomes.append((answers, refused, fleet.stats()["reroutes"]))
        (port_answers, port_refused, port_reroutes), (jax_answers, jax_refused, jax_reroutes) = outcomes
        assert [(r.replica, r.served_by) for r in port_answers] == [(r.replica, r.served_by) for r in jax_answers]
        assert {r.served_by for r in port_answers} == {"fallback"} and {r.replica for r in port_answers} == {"r1"}
        for p, j in zip(port_answers, jax_answers):
            np.testing.assert_allclose(p.scores, j.scores, atol=ATOL, rtol=RTOL)
        assert port_refused == jax_refused == "KeyError"
        assert port_reroutes == jax_reroutes > 0
    finally:
        for fleet in fleets:
            fleet.close()


# --------------------------------------------------------------------------- #
# replicas sharing one card and one model, under thread switches
# --------------------------------------------------------------------------- #
def test_engines_sharing_one_model_keep_their_own_weights(models):
    """Replicas built on one model object run their programs from several
    serve workers at once: each binds its own weights (``nn/compiled.py::bind``
    serialises ``functional_call`` per model), so every thread's logits equal
    its engine's single-threaded ones, bitwise."""
    port_model = models[0]
    base = port_model.state_dict()
    weights = [{k: v * (1.0 + 0.25 * i) for k, v in base.items()} for i in range(3)]
    engines = [ScoringEngine(port_model, w, batch_buckets=(4,), device="cpu") for w in weights]
    rng = np.random.default_rng(13)
    ids = rng.integers(0, NUM_ITEMS, size=(4, SEQ_LEN)).astype(np.int32)
    mask = np.ones((4, SEQ_LEN), bool)
    want = [engine.encode(SEQ_LEN, ids, mask)[0].clone() for engine in engines]
    failures, errors = [], []

    def worker(index):
        try:
            for _ in range(40):
                got = engines[index % 3].encode(SEQ_LEN, ids, mask)[0]
                if not torch.equal(got, want[index % 3]):
                    failures.append(index)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(12)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=WAIT_S * 6)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert errors == [] and failures == []


def test_launch_counts_lose_no_update_across_threads():
    """Serve workers of several services add to one wrapper's counts at once
    (``ops/counts.py``): no increment is lost."""

    class Wrapper:
        launches = 0
        launches_by_variant = {"a": 0}

    def worker():
        for _ in range(5000):
            counts.add(Wrapper, "a")
        counts.add_recorded([(Wrapper, None)] * 1000)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=WAIT_S * 6)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert Wrapper.launches == 16 * 6000 and Wrapper.launches_by_variant["a"] == 16 * 5000
