"""The port's ScoringService against the JAX package's, then its contracts.

Both services serve ``SasRec(use_flash=True)`` on the same weights (carried
across with ``convert.flax_to_torch``); the JAX side runs K4's Pallas kernel
in interpret mode, the port K4's plain version on the CPU. The same request
sequence goes to both, in ``full``, ``slate`` and ``retrieval`` mode (over
the brute f32 index, and over the int8 table with its exact rescore stage),
so the micro-batches are the same: scores agree at atol/rtol 1e-5, and top-k ids,
``served_from``, ``served_by``, ``lane`` and ``batch_bucket`` exactly.

Then, on the port alone, the contracts ``tests/serve/test_service_parity.py``
and ``tests/serve/test_service_resilience.py`` hold for JAX: bitwise fill,
co-rider and row-order independence within a bucket, advance = re-encode,
cache-only = pure hit, the breaker and the degradation ladder, deadlines,
shedding, close, hot swaps and the four plane arguments. Every wait is bounded
(``WAIT_S``), and every service is closed in a ``finally``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.models.ann import MIPSIndex as JaxMIPSIndex
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.serve.pipeline import CandidatePipeline as JaxCandidatePipeline
from replay_tpu.serve.service import ScoringService as JaxScoringService
from replay_tpu.utils.faults import EngineErrorAt, InjectedFault, LatencySpike, wrap_method
from replay_tpu_torch.convert import flax_to_torch
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.models import MIPSIndex
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.obs import Tracer
from replay_tpu_torch.serve import (
    CandidatePipeline,
    CircuitBreaker,
    CircuitOpen,
    DeadlineExceeded,
    FallbackScorer,
    RequestShed,
    ScoringService,
    ServiceClosed,
)

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN = 40, 16, 2, 2, 16
LENGTHS, BATCHES = (8, SEQ_LEN), (1, 4)
SLATE = np.array([3, 7, 11, 19, 23, 31, 39], np.int32)
RERANK = np.array([1.5, -0.2], np.float32)
ATOL = RTOL = 1e-5
WAIT_S = 10.0
MAX_WAIT_MS = 40.0  # long enough that 2-4 back-to-back submits share one batch
HISTORY = [3, 1, 4, 1, 5]
# the service planes the JAX service takes as arguments
PLANE_ARGS = ("metrics_port", "slo_rules", "quality", "flight_path")


def _jax_model():
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return JaxSasRec(
        schema=schema, embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, use_flash=True,
    )


def _port_model(use_flash=True):
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return SasRec(
        schema, embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, use_flash=use_flash, device="cpu",
    )


@pytest.fixture(scope="module")
def setup():
    jax_model = _jax_model()
    ids = np.zeros((2, SEQ_LEN), np.int32)
    params = jax_model.init(jax.random.PRNGKey(0), {"item_id": ids}, np.ones((2, SEQ_LEN), bool))
    params = jax.tree.map(np.asarray, params["params"])
    return jax_model, _port_model(), params


def _item_weights(params):
    return np.asarray(params["body"]["embedder"]["embedding_item_id"]["table"]["embedding"][:NUM_ITEMS])


def _mode_kwargs(mode, params, port):
    if mode == "slate":
        return {"candidates": SLATE}
    if mode.startswith("retrieval"):
        weights = _item_weights(params)
        precision = "int8" if mode == "retrieval_int8" else "f32"
        index = MIPSIndex(weights, precision=precision, device="cpu") if port else JaxMIPSIndex(weights, precision=precision)
        pipeline = CandidatePipeline if port else JaxCandidatePipeline
        return {"retrieval": pipeline(index, num_candidates=12, top_k=6, reranker_weights=RERANK)}
    return {}


def _service(setup, mode="full", model=None, **kwargs):
    _, port_model, params = setup
    kwargs = {"length_buckets": LENGTHS, "batch_buckets": BATCHES, "max_wait_ms": MAX_WAIT_MS, **kwargs}
    return ScoringService(
        model if model is not None else port_model, flax_to_torch(params), device="cpu",
        **_mode_kwargs(mode, params, port=True), **kwargs,
    )


def _jax_service(setup, mode="full", **kwargs):
    jax_model, _, params = setup
    kwargs = {"length_buckets": LENGTHS, "batch_buckets": BATCHES, "max_wait_ms": MAX_WAIT_MS, **kwargs}
    return JaxScoringService(jax_model, params, **_mode_kwargs(mode, params, port=False), **kwargs)


def _histories(seed, count):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, NUM_ITEMS, rng.integers(1, 2 * SEQ_LEN)))) for _ in range(count)]


def _sequence(service, mode):
    """One request sequence, sent from one thread: singles through score(),
    then groups submitted back to back (one micro-batch each: the lane fills,
    or its max_wait passes after the last submit)."""
    responses = []
    users = _histories(7, 6)
    k = 3 if not mode.startswith("retrieval") else None

    def score(user, **kwargs):
        responses.append(service.score(user, timeout=WAIT_S, **kwargs))

    def group(requests):
        futures = [service.submit(user, **kwargs) for user, kwargs in requests]
        responses.extend(f.result(timeout=WAIT_S) for f in futures)

    for user, history in enumerate(users[:3]):
        score(user, history=history)  # cold, one per length bucket and more
    score(0)  # pure hit
    score(1, new_items=[9])  # advance
    score(2, k=3)  # hit, top-k cut
    score(2, history=users[2] + [5, 6])  # resend: cold again
    if mode == "full":
        score(0, candidates=[5, 0, 17, 17])
    group([(u, {"history": users[u]}) for u in range(3, 6)])  # 3 colds: bucket 4
    group([(u, {}) for u in range(4)])  # 4 hits: a full lane
    group([(3, {"new_items": [1]}), (4, {"new_items": [2, 3]}), (0, {"k": k})])
    return responses


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _errors(service, mode):
    """The refusals of one mode, as (type, message): an unknown user, an
    advance without state, and the mode's own request errors."""
    requests = [("nobody", {}), ("nobody", {"new_items": [1]})]
    requests.append(("seed", {"k": 50} if mode.startswith("retrieval") else {"candidates": [1, 2]} if mode == "slate" else {"k": 2}))
    service.score("seed", history=HISTORY, timeout=WAIT_S)
    out = []
    for user, kwargs in requests:
        exc = service.submit(user, **kwargs).exception(timeout=WAIT_S)
        out.append(None if exc is None else (type(exc).__name__, str(exc)))
    return out


def _run(service, mode):
    try:
        with service:
            return _sequence(service, mode), _errors(service, mode), service.stats()
    finally:
        service.close()


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX service's answers per mode, computed once (its AOT compiles
    take seconds)."""
    runs = {}

    def run(mode):
        if mode not in runs:
            runs[mode] = _run(_jax_service(setup, mode), mode)
        return runs[mode]

    return run


def _assert_responses_match(got, want):
    assert len(got) == len(want) > 10
    for index, (g, w) in enumerate(zip(got, want)):
        where = f"response {index} ({w.served_from}, {w.lane}, bucket {w.batch_bucket})"
        assert (g.user_id, g.served_from, g.served_by, g.lane, g.batch_bucket, g.generation, g.role) == (
            w.user_id, w.served_from, w.served_by, w.lane, w.batch_bucket, w.generation, w.role
        ), where
        assert g.scores.shape == w.scores.shape and g.scores.dtype == w.scores.dtype, where
        np.testing.assert_allclose(g.scores, _np(w.scores), atol=ATOL, rtol=RTOL, err_msg=where)
        if w.item_ids is None:
            assert g.item_ids is None, where
        else:
            np.testing.assert_array_equal(g.item_ids, w.item_ids, err_msg=where)
    assert {b.batch_bucket for b in got} == set(BATCHES)


@pytest.mark.parametrize("mode", ["full", "slate", "retrieval", "retrieval_int8"])
def test_service_matches_jax(setup, jax_runs, mode):
    want, want_errors, want_stats = jax_runs(mode)
    got, got_errors, got_stats = _run(_service(setup, mode), mode)
    _assert_responses_match(got, want)
    assert got_errors == want_errors
    for key in ("mode", "requests", "answered", "errors", "served_from", "served_by", "cache_hit_rate",
                "pure_hit_rate", "batch_fill_ratio", "engine", "cache", "generations", "quality"):
        assert got_stats[key] == want_stats[key], key


# -- the port's own contracts ----------------------------------------------------- #
@pytest.fixture()
def service(setup, request):
    mode = getattr(request, "param", "full")
    service = _service(setup, mode).start()
    try:
        yield service
    finally:
        service.close()


def _target_in_batch(service, target, position, fill):
    """Score ``target`` at row ``position`` of one batch of ``fill`` colds."""
    others = _histories(position * 10 + fill, fill - 1)
    rows = others[:position] + [target] + others[position:]
    futures = [service.submit(f"u{position}-{fill}-{i}", history=h) for i, h in enumerate(rows)]
    responses = [f.result(timeout=WAIT_S) for f in futures]
    return responses[position]


@pytest.mark.parametrize("service", ["full", "retrieval"], indirect=True)
def test_scores_ignore_fill_co_riders_and_row_order_bitwise(service):
    target = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    seen = []
    for fill, position in ((2, 0), (2, 1), (3, 2), (4, 0), (4, 3)):
        response = _target_in_batch(service, target, position, fill)
        assert response.batch_bucket == 4 and response.lane == f"encode:L={SEQ_LEN}"
        seen.append(response)
    for response in seen[1:]:
        np.testing.assert_array_equal(response.scores, seen[0].scores)
        if response.item_ids is not None:
            np.testing.assert_array_equal(response.item_ids, seen[0].item_ids)


@pytest.mark.parametrize("service", ["full", "retrieval"], indirect=True)
def test_advance_is_bitwise_a_full_reencode(service):
    service.score("adv", history=HISTORY, timeout=WAIT_S)
    advanced = service.score("adv", new_items=[7, 9], timeout=WAIT_S)
    resent = service.score("fresh", history=HISTORY + [7, 9], timeout=WAIT_S)
    assert (advanced.served_from, resent.served_from) == ("advance", "cold")
    assert (advanced.lane, advanced.batch_bucket) == (resent.lane, resent.batch_bucket)
    np.testing.assert_array_equal(advanced.scores, resent.scores)
    rolled = service.score("adv", new_items=list(range(20)), timeout=WAIT_S)  # past the window
    np.testing.assert_array_equal(
        rolled.scores, service.score("fresh2", history=HISTORY + [7, 9] + list(range(20)), timeout=WAIT_S).scores
    )


def test_pure_hit_skips_the_encoder(service):
    cold = service.score("hit", history=HISTORY, timeout=WAIT_S)
    encodes = service.engine.encode_calls
    hits = [service.score("hit", timeout=WAIT_S) for _ in range(2)]
    assert service.engine.encode_calls == encodes
    assert all(h.served_from == "hit" and h.lane == "hit" for h in hits)
    np.testing.assert_array_equal(hits[0].scores, hits[1].scores)
    np.testing.assert_allclose(hits[0].scores, cold.scores, atol=1e-6, rtol=1e-6)


def test_unknown_user_fails_fast(service):
    future = service.submit("nobody")
    with pytest.raises(KeyError, match="no cached state"):
        future.result(timeout=WAIT_S)


def _wait_for(injector):
    deadline = time.perf_counter() + WAIT_S
    while not injector.injected_at:
        assert time.perf_counter() < deadline, "the injected stall never started"
        time.sleep(0.002)


def test_full_lane_sheds_and_deadlines_expire_at_batch_build(setup):
    service = _service(setup, max_queue_depth=1, max_wait_ms=1.0).start()
    try:
        spike = LatencySpike(at_calls=[0], duration_s=0.4)
        wrap_method(service.engine, "encode", spike)
        blocker = service.submit("blocker", history=HISTORY)
        _wait_for(spike)  # the worker is wedged in the first encode
        doomed = service.submit("doomed", history=HISTORY, deadline_ms=30.0)  # fills the lane
        with pytest.raises(RequestShed) as shed:
            service.submit("over", history=HISTORY).result(timeout=WAIT_S)
        assert shed.value.max_depth == 1 and shed.value.retry_after_s is not None
        with pytest.raises(DeadlineExceeded) as late:
            doomed.result(timeout=WAIT_S)
        assert late.value.waited_s >= 0.03 - 1e-3
        blocker.result(timeout=WAIT_S)
        stats = service.stats()
        assert (stats["shed"], stats["deadline_misses"], stats["served_from"]["cold"]) == (1, 1, 1)
        assert service.engine.encode_calls == 1  # the expired request never reached the engine
    finally:
        service.close()


def test_breaker_opens_on_engine_failures_and_a_probe_closes_it(setup):
    transitions = []
    service = _service(
        setup, breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.15,
                                      on_transition=lambda old, new, info: transitions.append((old, new))),
    ).start()
    try:
        wrap_method(service.engine, "encode", EngineErrorAt(at_calls=range(2)))
        for i in range(2):
            with pytest.raises(InjectedFault):
                service.submit(f"trip{i}", history=HISTORY).result(timeout=WAIT_S)
        assert service.breaker.state == "open"
        with pytest.raises(CircuitOpen):  # no cached state, no fallback: refused
            service.submit("refused", history=HISTORY).result(timeout=WAIT_S)
        time.sleep(0.2)  # past the reset window: the next encode is the probe
        response = service.score("probe", history=HISTORY, timeout=WAIT_S)
        assert response.served_by == "primary" and service.breaker.state == "closed"
        assert transitions == [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
        assert service.stats()["circuit_refusals"] == 1
    finally:
        service.close()


@pytest.mark.parametrize("mode", ["full", "retrieval"])
def test_ladder_cache_only_is_the_pure_hit_and_fallback_serves_cold(setup, mode):
    fallback = FallbackScorer(np.arange(NUM_ITEMS, dtype=np.float32))
    service = _service(setup, mode, fallback=fallback).start()
    try:
        service.score("warm", history=HISTORY, timeout=WAIT_S)
        reference = service.score("warm", timeout=WAIT_S)
        for _ in range(service.breaker.failure_threshold):
            service.breaker.record_failure()
        assert service.breaker.state == "open"
        assert service.score("warm", timeout=WAIT_S).served_by == "primary"  # a pure hit needs no encode
        degraded = service.score("warm", new_items=[7], timeout=WAIT_S)
        assert (degraded.served_by, degraded.served_from, degraded.batch_bucket) == ("cache_only", "hit", reference.batch_bucket)
        np.testing.assert_array_equal(degraded.scores, reference.scores)
        assert service.cache.peek("warm").window[-1] == 7  # the interaction landed
        cold = service.score("brand-new", history=HISTORY, timeout=WAIT_S)
        assert (cold.served_by, cold.served_from) == ("fallback", "fallback")
        want_scores, want_ids = fallback.score(k=6) if mode == "retrieval" else fallback.score()
        np.testing.assert_array_equal(cold.scores, want_scores)
        assert (cold.item_ids is None) == (want_ids is None)
        assert service.stats()["served_by"] == {"primary": 3, "cache_only": 1, "fallback": 1}
    finally:
        service.close()


def test_close_resolves_every_pending_future(setup):
    service = _service(setup).start()
    wrap_method(service.engine, "encode", EngineErrorAt(at_calls=range(10_000)))
    futures = [service.submit(f"u{i}", history=HISTORY) for i in range(6)]
    service.close()
    for future in futures:
        assert future.done() and isinstance(future.exception(timeout=0), Exception)
    late = service.submit("late", history=HISTORY)
    assert late.done() and isinstance(late.exception(timeout=0), ServiceClosed)


@pytest.mark.parametrize("mode", ["full", "retrieval"])
def test_same_shape_publish_and_promote_is_bitwise(setup, mode):
    _, port_model, params = setup
    candidate = jax.tree.map(lambda a: (a * 1.01).astype(a.dtype), params)
    history = [2, 7, 1, 8, 2, 8]
    service = _service(setup, mode).start()
    fresh = None
    try:
        before = service.score("u", history=history, timeout=WAIT_S)
        pipeline = _mode_kwargs(mode, candidate, port=True).get("retrieval")
        generation = service.publish_candidate(flax_to_torch(candidate), label="v1", pipeline=pipeline)
        assert service.store.generation(generation).engine is None  # the same programs, no rebuild
        encoders = dict(service.engine._encoders)
        assert service.promote(generation) == {"from_generation": 0, "to_generation": generation}
        assert service.engine._encoders == encoders
        hit = service.score("u", timeout=WAIT_S)  # encoded by generation 0: a miss, re-encoded
        after = service.score("u", history=history, timeout=WAIT_S)
        assert (hit.served_from, hit.generation, after.generation) == ("advance", generation, generation)
        fresh = ScoringService(
            port_model, flax_to_torch(candidate), length_buckets=LENGTHS, batch_buckets=BATCHES,
            max_wait_ms=MAX_WAIT_MS, device="cpu", **_mode_kwargs(mode, candidate, port=True),
        ).start()
        want = fresh.score("u", history=history, timeout=WAIT_S)
        np.testing.assert_array_equal(after.scores, want.scores)
        np.testing.assert_array_equal(hit.scores, want.scores)
        assert not np.array_equal(before.scores, after.scores)
        assert service.rollback()["to_generation"] == 0
        np.testing.assert_array_equal(service.score("u", history=history, timeout=WAIT_S).scores, before.scores)
        assert [e["event"] for e in service.generation_history()] == ["published", "published", "promoted", "rolled_back"]
    finally:
        service.close()
        if fresh is not None:
            fresh.close()


@pytest.mark.parametrize("name", PLANE_ARGS)
def test_refused_arguments_name_their_roadmap_item(setup, name, tmp_path):
    """The four plane arguments the service once refused (naming their
    roadmap item) are now accepted, each wiring its plane: the exporter, the
    SLO watchdog, the quality monitor and the flight ring."""
    from replay_tpu_torch.obs import PopularityDescriptor, QualityMonitor, SLORule, read_flight

    value = {
        "metrics_port": 0,
        "slo_rules": [SLORule("replay_serve_rows_total", ">", 0.0, name="rows")],
        "quality": QualityMonitor(PopularityDescriptor.from_train({0: [1, 2, 3]}, num_items=NUM_ITEMS)),
        "flight_path": str(tmp_path / "flight.ring"),
    }[name]
    service = _service(setup, **{name: value})
    with service:
        service.score("u", history=HISTORY, timeout=WAIT_S)
        if name == "metrics_port":
            assert service.metrics_exporter.url.startswith("http://")
        if name == "slo_rules":
            assert service.metrics_registry.value("replay_slo_violations_total", labels={"rule": "rows"}) == 1.0
        if name == "quality":
            assert service.stats()["quality"]["observed"] == 1
    if name == "flight_path":
        assert read_flight(value).records[-1]["event"] == "on_serve_end"


def test_service_defaults_to_the_card(setup, monkeypatch):
    _, port_model, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringService(port_model, flax_to_torch(params))


def test_worker_runs_under_inference_mode_and_records_spans(setup):
    tracer = Tracer()
    service = _service(setup, "retrieval", tracer=tracer).start()
    seen = []
    score_hidden = service.engine.encode

    def spy(*args, **kwargs):
        seen.append((torch.is_inference_mode_enabled(), threading.current_thread().name))
        return score_hidden(*args, **kwargs)

    service.engine.encode = spy
    try:
        service.score("a", history=HISTORY, timeout=WAIT_S)
        service.score("a", timeout=WAIT_S)
    finally:
        service.close()
    assert seen == [(True, "serve-microbatcher")]
    names = [e["name"] for e in tracer.to_chrome_trace()["traceEvents"]]
    for name in ("queue_wait", "batch_build", "score", "retrieve", "rerank"):
        assert name in names, name


def test_tiled_model_behind_the_service_matches_jax(setup, jax_runs):
    """A use_flash="tiled" model (K5's plain version on the CPU) behind the
    service answers as the JAX service on the K4 model does, same weights."""
    want, want_errors, _ = jax_runs("full")
    got, got_errors, _ = _run(_service(setup, model=_port_model(use_flash="tiled")), "full")
    _assert_responses_match(got, want)
    assert got_errors == want_errors


def test_concurrent_advances_all_land_under_a_short_switch_interval(setup):
    """More client threads than cores advance the same users at once, with the
    interpreter switching threads every 10 µs: every interaction must land in
    its user's window (an unlocked read-modify-write of the cache would drop
    one), and the service's counters must add up."""
    import os
    import sys

    users, per_user = 4, 15  # 1 + 15 items fit the L=16 window
    threads_count = max(8, 2 * (os.cpu_count() or 1))
    service = _service(setup).start()
    interval = sys.getswitchinterval()
    errors = []
    try:
        for user in range(users):
            service.score(user, history=[user], timeout=WAIT_S)
        jobs = [(user, (7 * user + n) % NUM_ITEMS) for user in range(users) for n in range(per_user)]

        def client(index):
            try:
                for user, item in jobs[index::threads_count]:
                    service.submit(user, new_items=[item]).result(timeout=WAIT_S)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(threads_count)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=4 * WAIT_S)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
        service.close()
    assert not errors
    for user in range(users):
        state = service.cache.peek(user)
        landed = sorted(state.window[state.mask].tolist())
        assert landed == sorted([user] + [item for u, item in jobs if u == user])
    stats = service.stats()
    assert stats["requests"] == stats["answered"] == users * (per_user + 1)
    assert stats["cache"]["advances"] == users * per_user
