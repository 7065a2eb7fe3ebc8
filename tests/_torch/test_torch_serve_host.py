"""The service's host-only modules: each port copy against its JAX original.

``CircuitBreaker``, ``UserStateCache``, ``MicroBatcher``, ``FallbackScorer``,
``ParamStore``/``in_canary_slice``, ``Tracer``/``goodput_breakdown`` and
``JsonlLogger`` run the same scripted inputs on both sides (a fake clock where
time matters); their observable results must be equal. Every wait is bounded.
"""

import json
import threading
import time

import numpy as np
import pytest

from replay_tpu.obs import events as jax_events
from replay_tpu.obs import trace as jax_trace
from replay_tpu.serve import batcher as jax_batcher
from replay_tpu.serve import breaker as jax_breaker
from replay_tpu.serve import cache as jax_cache
from replay_tpu.serve import degrade as jax_degrade
from replay_tpu.serve import errors as jax_errors
from replay_tpu.serve import futures as jax_futures
from replay_tpu.serve import promote as jax_promote
from replay_tpu_torch.obs import events, trace
from replay_tpu_torch.serve import batcher, breaker, cache, degrade, errors, futures, promote

WAIT_S = 5.0


class FakeClock:
    def __init__(self, start=100.0):
        self.now = start

    def __call__(self):
        return self.now


# -- CircuitBreaker ----------------------------------------------------------- #
# scripts of (op, arg): "allow", "ok", "fail", "tick" (advance the clock by arg)
BREAKER_SCRIPTS = {
    "trip_at_threshold": [("fail", None)] * 3 + [("allow", None)] * 2,
    "success_resets_streak": [("fail", None), ("fail", None), ("ok", None), ("fail", None), ("fail", None), ("allow", None)],
    "probe_closes": [("fail", None)] * 3 + [("allow", None), ("tick", 0.5), ("allow", None), ("allow", None), ("ok", None), ("allow", None)],
    "probe_fails_reopens": [("fail", None)] * 3 + [("tick", 0.5), ("allow", None), ("fail", None), ("allow", None), ("tick", 0.49), ("allow", None), ("tick", 0.02), ("allow", None)],
    "vanished_probe_reclaimed": [("fail", None)] * 3 + [("tick", 0.5), ("allow", None), ("allow", None), ("tick", 0.5), ("allow", None), ("ok", None)],
}


def _run_breaker(module, script):
    clock = FakeClock()
    transitions = []
    b = module.CircuitBreaker(
        failure_threshold=3, reset_timeout_s=0.5, clock=clock,
        on_transition=lambda old, new, info: transitions.append((old, new, dict(info))),
    )
    trail = []
    for op, arg in script:
        if op == "allow":
            trail.append(b.allow())
        elif op == "ok":
            b.record_success()
        elif op == "fail":
            b.record_failure()
        else:
            clock.now += arg
        trail.append((b.state, b.retry_after_s(), b.stats()))
    return trail, transitions


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_transitions_match(script):
    assert _run_breaker(breaker, BREAKER_SCRIPTS[script]) == _run_breaker(jax_breaker, BREAKER_SCRIPTS[script])


@pytest.mark.parametrize("kwargs", [{"failure_threshold": 0}, {"half_open_max_probes": 0}])
def test_breaker_argument_errors_match(kwargs):
    with pytest.raises(ValueError) as want:
        jax_breaker.CircuitBreaker(**kwargs)
    with pytest.raises(ValueError, match=str(want.value)):
        breaker.CircuitBreaker(**kwargs)


# -- UserStateCache ----------------------------------------------------------- #
def _cache_script(module, seed):
    rng = np.random.default_rng(seed)
    c = module.UserStateCache(capacity=4)
    trail = []
    for step in range(60):
        user = int(rng.integers(0, 7))
        op = rng.integers(0, 5)
        if op == 0:
            items = list(rng.integers(0, 30, rng.integers(1, 12)))
            window, mask, length = module.make_window(items, 8, 0)
            c.store(user, module.UserState(window=window, mask=mask, length=length, generation=step))
            trail.append(("store", user))
        elif op == 1:
            state = c.lookup(user)
            trail.append(("lookup", user, None if state is None else (state.window.tolist(), state.length)))
        elif op == 2:
            state = c.advance_user(user, list(rng.integers(0, 30, rng.integers(1, 4))), pad_id=0)
            trail.append(("advance", user, None if state is None else (state.window.tolist(), state.mask.tolist(), state.generation)))
        elif op == 3:
            state = c.peek(user)
            if state is not None:
                stale = module.UserState(state.window, state.mask, state.length, generation=state.generation - int(rng.integers(0, 2)))
                c.refresh_embedding(user, stale, np.full(4, step, np.float32), param_generation=step % 3)
            trail.append(("refresh", user))
        else:
            state = c.peek(user)
            trail.append(("peek", user, None if state is None else (
                state.length, state.generation, state.param_generation,
                None if state.embedding is None else state.embedding.tolist(),
            )))
        trail.append(list(c._states))  # LRU order, oldest first
    return trail, c.stats()


@pytest.mark.parametrize("seed", range(4))
def test_cache_lru_hits_and_advances_match(seed):
    assert _cache_script(cache, seed) == _cache_script(jax_cache, seed)


def test_cache_advance_rolls_the_window_like_jax():
    for module in (cache, jax_cache):
        window, mask, length = module.make_window(list(range(1, 9)), 8)
        state = module.UserState(window, mask, length)
        advanced = module.UserStateCache(2).advance(state, [11, 12], pad_id=0)
        assert advanced.window.tolist() == [3, 4, 5, 6, 7, 8, 11, 12] and advanced.embedding is None
    with pytest.raises(ValueError, match="positive"):
        cache.UserStateCache(0)


# -- MicroBatcher ------------------------------------------------------------- #
def _wait_until(predicate):
    deadline = time.perf_counter() + WAIT_S
    while not predicate():
        assert time.perf_counter() < deadline, "timed out"
        time.sleep(0.001)


def _flush_sizes(module, items, capacity):
    sizes, lock = [], threading.Lock()

    def dispatch(lane, batch):
        with lock:
            sizes.append((lane, list(batch)))

    b = module.MicroBatcher(dispatch, capacity=capacity, max_wait=60.0).start()
    try:
        for lane, item in items:
            b.submit(lane, item)
    finally:
        b.stop(timeout=WAIT_S)  # a full lane flushes whenever the worker sees it
    return sizes, b.stats()


@pytest.mark.parametrize("count", [3, 4, 10, 17])
def test_batcher_flush_sizes_match(count):
    """Full lanes flush at capacity, before or at stop(); the rest (max_wait is
    far away) at stop()."""
    items = [("encode" if i % 3 else "hit", i) for i in range(count)]
    got, want = _flush_sizes(batcher, items, 4), _flush_sizes(jax_batcher, items, 4)
    assert sorted(map(repr, got[0])) == sorted(map(repr, want[0]))
    assert got[1] == want[1]


def _shed(module):
    release = threading.Event()
    b = module.MicroBatcher(lambda lane, batch: release.wait(WAIT_S), capacity=1, max_wait=0.25, max_depth=2).start()
    try:
        b.submit("encode", 0)
        _wait_until(lambda: b.queued_depth() == 0 and not b.idle)  # the worker holds item 0
        b.submit("encode", 1)
        b.submit("encode", 2)
        with pytest.raises(module.RequestShed) as shed:
            b.submit("encode", 3)
        record = (str(shed.value), shed.value.depth, shed.value.max_depth, shed.value.retry_after_s, b.stats())
    finally:
        release.set()
        b.stop(timeout=WAIT_S)
    with pytest.raises(module.ServiceClosed, match="not running"):
        b.submit("encode", 4)
    return record, b.stats()


def test_batcher_sheds_at_max_depth_like_jax():
    assert _shed(batcher) == _shed(jax_batcher)


def test_batcher_stop_fails_what_a_wedged_worker_holds():
    for module in (batcher, jax_batcher):
        release, failed = threading.Event(), []
        b = module.MicroBatcher(
            lambda lane, batch: release.wait(WAIT_S), capacity=1, max_wait=60.0,
            on_error=lambda lane, batch, exc: failed.append((batch, type(exc).__name__)),
        ).start()
        b.submit("encode", 0)
        _wait_until(lambda: not b.idle and b.queued_depth() == 0)
        b.submit("encode", 1)
        b.stop(timeout=0.05)
        release.set()
        assert failed == [([1], "ServiceClosed"), ([0], "ServiceClosed")], module.__name__


# -- errors and futures --------------------------------------------------------- #
@pytest.mark.parametrize(
    "name, args",
    [
        ("RequestShed", (("encode", 16), 3, 4, 0.25)),
        ("RequestShed", ("hit", 1, 1, None)),
        ("DeadlineExceeded", (0.031, 0.03)),
        ("CircuitOpen", (1.5,)),
        ("CircuitOpen", ()),
        ("ServiceClosed", ()),
        ("ServiceClosed", ("MicroBatcher stopped before this request was served",)),
    ],
)
def test_errors_match(name, args):
    got, want = getattr(errors, name)(*args), getattr(jax_errors, name)(*args)
    assert str(got) == str(want) and isinstance(got, errors.ServeError) and isinstance(got, RuntimeError)


def test_future_helpers_match():
    from concurrent.futures import Future

    for module in (futures, jax_futures):
        done, cancelled, fresh = Future(), Future(), Future()
        assert module.safe_set_result(done, 1) and not module.safe_set_result(done, 2)
        assert not module.safe_fail(done, ValueError()) and done.result() == 1
        assert cancelled.cancel() and not module.mark_running(cancelled)
        assert module.mark_running(fresh) and not fresh.cancel() and module.safe_fail(fresh, KeyError("x"))
        assert not module.mark_running(done)


# -- FallbackScorer ----------------------------------------------------------- #
@pytest.mark.parametrize("call", [{}, {"k": 5}, {"k": 1}, {"candidates": [4, 0, 9, 9]}])
def test_fallback_scores_match(call):
    rng = np.random.default_rng(3)
    interactions = rng.integers(0, 12, 80)  # repeated counts: ties break to the smaller id
    got = degrade.FallbackScorer.from_interactions(interactions, 15)
    want = jax_degrade.FallbackScorer.from_interactions(interactions, 15)
    np.testing.assert_array_equal(got.ranking, want.ranking)
    for a, b in zip(got.score(**call), want.score(**call)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert got.stats() == want.stats() and degrade.DEGRADATION_LADDER == jax_degrade.DEGRADATION_LADDER
    with pytest.raises(ValueError, match="non-empty 1-D"):
        degrade.FallbackScorer([])


# -- ParamStore and the canary slice ------------------------------------------- #
STORE_SCRIPTS = {
    "publish_promote_rollback": ["publish", "promote", "publish", "promote", "rollback", "publish", "rollback"],
    "eviction": ["publish"] * 6 + ["promote", "publish", "clear", "publish"],
    "nothing_to_roll_back": ["rollback"],
    "promote_without_candidate": ["promote"],
}


def _run_store(module, script):
    clock = FakeClock()
    store = module.ParamStore({"w": 0}, pipeline="p0", keep_history=2, clock=clock)
    trail = []
    for op in script:
        clock.now += 1.0
        try:
            if op == "publish":
                result = store.publish({"w": clock.now}, label=f"at{clock.now}")
            elif op == "promote":
                result = store.promote()
            elif op == "rollback":
                result = store.rollback()
            else:
                result = store.clear_candidate()
        except (ValueError, KeyError) as exc:
            result = (type(exc).__name__, str(exc))
        trail.append((op, result, store.resolve("stable").number, store.resolve("candidate").number, store.stats()))
    try:
        store.generation(0)
        resident = True
    except KeyError:
        resident = False
    return trail, store.history(), resident


@pytest.mark.parametrize("script", sorted(STORE_SCRIPTS))
def test_param_store_generations_match(script):
    assert _run_store(promote, STORE_SCRIPTS[script]) == _run_store(jax_promote, STORE_SCRIPTS[script])


@pytest.mark.parametrize("fraction", [-0.5, 0.0, 0.1, 0.37, 0.5, 1.0, 1.2])
def test_canary_slice_routing_matches(fraction):
    users = [*range(300), *(f"user-{i}" for i in range(100)), ("tuple", 3)]
    got = [promote.in_canary_slice(u, fraction) for u in users]
    assert got == [jax_promote.in_canary_slice(u, fraction) for u in users]
    assert promote.ROLES == jax_promote.ROLES


# -- Tracer and goodput ----------------------------------------------------------- #
def _traced(module):
    clock = FakeClock(10.0)
    tracer = module.Tracer()
    tracer._clock, tracer._t0, tracer._wall0 = clock, clock(), 0.0
    start = tracer.now()
    with tracer.span("batch_build", rows=3):
        clock.now += 0.002
        with tracer.span("score", lane="hit"):
            clock.now += 0.005
        clock.now += 0.001
    with tracer.span("retrieve", k=100) as span:
        clock.now += 0.004
    tracer.carve(span, "rerank", 0.001)
    clock.now += 0.003
    waited = module.lifecycle_span(tracer, "queue_wait", start, lane="encode:L=50", trace_id="t-1")
    tracer.add_span("fallback", tracer.now(), 0.0, reason="breaker_open")
    off = module.Tracer(enabled=False)
    with off.span("score"):
        pass
    events = [{k: v for k, v in e.items() if k != "tid"} for e in tracer.to_chrome_trace()["traceEvents"]]
    return (
        waited, events, tracer.summary(), tracer.snapshot(), off.summary(),
        module.goodput_breakdown(tracer.snapshot(), tracer.wall_seconds(), spans=module.SERVE_GOODPUT_SPANS),
        module.goodput_breakdown({"score": 3.0, "queue_wait": 2.0}, 4.0, spans=module.SERVE_GOODPUT_SPANS),
        module.goodput_breakdown({"train_step": 1.0, "data_wait": 0.5}, 2.0),
        module.goodput_breakdown({}, 0.0, spans=module.SERVE_GOODPUT_SPANS),
    )


def test_tracer_spans_and_goodput_match(tmp_path):
    got, want = _traced(trace), _traced(jax_trace)
    assert got == want
    fractions = got[5]["fractions"]
    assert sum(fractions.values()) == pytest.approx(1.0)
    assert trace.SERVE_GOODPUT_SPANS == jax_trace.SERVE_GOODPUT_SPANS and trace.GOODPUT_SPANS == jax_trace.GOODPUT_SPANS
    tracer = trace.Tracer()
    with tracer.span("score"):
        pass
    saved = json.loads(open(tracer.save(str(tmp_path / "t" / "trace.json"))).read())
    assert [e["name"] for e in saved["traceEvents"]] == ["score"]


def test_trace_context_round_trips_like_jax():
    for module in (trace, jax_trace):
        ctx = module.TraceContext("t-abc", parent_span="route")
        assert module.TraceContext.from_json(ctx.to_json()).to_json() == {"trace_id": "t-abc", "parent_span": "route"}
        assert module.TraceContext.from_json(None) is None and module.TraceContext.mint().trace_id.startswith("t-")


# -- JsonlLogger ----------------------------------------------------------------- #
def _log(module, run_dir, **kwargs):
    sink = module.JsonlLogger(str(run_dir), **kwargs)
    records = [
        module.TrainerEvent("on_serve_start", time=1.0, payload={"mode": "retrieval", "buckets": (1, 8, 64)}),
        module.TrainerEvent("on_serve_batch", step=3, epoch=0, time=2.0, payload={"fill": np.float32(0.5), "rows": np.int64(4)}),
        module.TrainerEvent("on_serve_end", time=3.0, payload={"nan": float("nan"), "arr": np.arange(3), "nested": {"a": [np.float64(1.5)]}}),
    ]
    for _ in range(4):
        for event in records:
            sink.log_event(event)
    sink.log_record({"raw": np.bool_(True)})
    sink.close()
    return sorted(p.name for p in run_dir.iterdir()), [(p.name, p.read_text()) for p in sorted(run_dir.iterdir())]


@pytest.mark.parametrize("kwargs", [{}, {"max_bytes": 400, "rotate": 2}, {"process_index": 2}])
def test_jsonl_logger_records_match(tmp_path, kwargs):
    got = _log(events, tmp_path / "port", **kwargs)
    want = _log(jax_events, tmp_path / "jax", **kwargs)
    assert got == want
    for _, text in got[1]:
        for line in text.splitlines():
            json.loads(line)  # strict JSON: NaN became null
