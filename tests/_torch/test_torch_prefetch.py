"""The port's ``prefetch`` and ``DevicePrefetcher`` against the JAX package's,
on the CPU, on scripted sources: the same items in the same order, an error of
the source or of ``place`` re-raised at the same point of consumption, the
same ``depth`` checks, and ``close`` stopping and joining the thread.

Every wait is bounded: consumption runs on a helper thread joined with a
timeout, so a hang fails the test in seconds instead of eating the run's clock.
"""

import threading
import time

import pytest

from replay_tpu.data.nn import DevicePrefetcher as JaxDevicePrefetcher
from replay_tpu.data.nn import prefetch as jax_prefetch
from replay_tpu_torch.data.nn import DevicePrefetcher, prefetch

WAIT_S = 10.0
IMPLEMENTATIONS = {"port": (prefetch, DevicePrefetcher), "jax": (jax_prefetch, JaxDevicePrefetcher)}


def bounded(fn):
    """``fn()`` on a helper thread, joined with a timeout: its result, or its error re-raised."""
    outcome = {}

    def run():
        try:
            outcome["value"] = fn()
        except BaseException as error:  # noqa: BLE001 - re-raised below
            outcome["error"] = error

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive(), f"no result within {WAIT_S} s"
    if "error" in outcome:
        raise outcome["error"]
    return outcome["value"]


def consume(iterator):
    """Every item until the end or an error: ``(items, repr of the error or None)``."""
    items = []
    try:
        for item in iterator:
            items.append(item)
    except RuntimeError as error:
        return items, repr(error)
    return items, None


def failing_source(after: int):
    def gen():
        yield from range(after)
        raise RuntimeError("source failed")

    return gen()


def spawned_thread(before, name):
    threads = [t for t in threading.enumerate() if t.ident not in before and name in t.name]
    assert len(threads) == 1
    return threads[0]


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_yields_the_jax_order_and_errors(depth):
    for source in (lambda: iter(range(20)), lambda: failing_source(5)):
        got = bounded(lambda: consume(prefetch(source(), depth=depth)))
        want = bounded(lambda: consume(jax_prefetch(source(), depth=depth)))
        assert got == want
    assert got == (list(range(5)), repr(RuntimeError("source failed")))


@pytest.mark.parametrize("depth", [1, 2])
def test_device_prefetcher_places_on_the_feeder_thread_like_jax(depth):
    def run(cls, fail_at=None):
        threads = set()

        def place(x):
            threads.add(threading.get_ident())
            if x == fail_at:
                raise RuntimeError("place failed")
            return x * 10

        def go():
            with cls(iter(range(6)), place, depth=depth) as feed:
                return consume(feed)

        return bounded(go), threads

    for fail_at in (None, 3):
        (got, got_threads), (want, _) = run(DevicePrefetcher, fail_at), run(JaxDevicePrefetcher, fail_at)
        assert got == want
        assert got_threads and threading.get_ident() not in got_threads
    assert got == ([(0, 0), (1, 10), (2, 20)], repr(RuntimeError("place failed")))


@pytest.mark.parametrize("implementation", sorted(IMPLEMENTATIONS))
def test_bad_depth_raises_at_call_time(implementation):
    prefetch_fn, prefetcher = IMPLEMENTATIONS[implementation]
    with pytest.raises(ValueError, match="depth"):
        prefetch_fn([1], depth=0)
    with pytest.raises(ValueError, match="depth"):
        prefetcher([1], place=lambda x: x, depth=0)


@pytest.mark.parametrize("stage", ["prefetch", "device-feed"])
def test_close_stops_and_joins_the_thread(stage):
    produced = {"n": 0}

    def endless():
        while True:
            produced["n"] += 1
            yield produced["n"]

    before = {t.ident for t in threading.enumerate()}
    if stage == "prefetch":
        it = prefetch(endless(), depth=2)
    else:
        it = DevicePrefetcher(endless(), lambda x: x, depth=2)
    first = bounded(lambda: next(it))
    assert first in (1, (1, 1))
    thread = spawned_thread(before, stage)
    bounded(it.close)
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive()
    count = produced["n"]
    time.sleep(0.2)
    assert produced["n"] == count  # the producer stopped for good
