"""The port's socket-boundary replicas against the JAX package's, on the CPU.

* The wire format: every refusal of the serve taxonomy maps to the same HTTP
  status and JSON payload in both packages, and is rebuilt as the same
  exception with its ``retry_after_s``; a response payload round-trips.
* The wire both ways, in process: a JAX ``ReplicaServer`` (a server thread
  over a scripted service) answers the port's ``RemoteReplica``, and a port
  ``ReplicaServer`` answers the JAX ``RemoteReplica`` — answers, refusals,
  heartbeats and stats alike.
* One spawned ``python -m replay_tpu_torch.serve.remote --device cpu``
  (the demo SASRec on K4's plain version): it answers through a fleet,
  publishes its metrics URL, is SIGKILLed, and three missed heartbeats
  declare it dead; its flight ring reads the same through both packages'
  ``read_flight`` and the run directory gives the same ``build_postmortem``.
* The demo server refuses to start without a card unless ``--device cpu``.

Every wait is bounded: the server's startup (``startup_timeout_s``), each
request (``timeout=``), the kill (``wait(timeout=...)``).
"""

import json
import os
import urllib.request
import zlib
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from replay_tpu.obs import blackbox as jax_blackbox
from replay_tpu.obs import postmortem as jax_postmortem
from replay_tpu.serve import errors as jax_errors
from replay_tpu.serve import remote as jax_remote
from replay_tpu.serve import request as jax_request
from replay_tpu_torch.obs import blackbox as port_blackbox
from replay_tpu_torch.obs import postmortem as port_postmortem
from replay_tpu_torch.parallel import clean_cpu_env
from replay_tpu_torch.serve import ServingFleet
from replay_tpu_torch.serve import errors as port_errors
from replay_tpu_torch.serve import remote as port_remote
from replay_tpu_torch.serve import request as port_request
from replay_tpu_torch.utils import KillAtStep

REPO = Path(__file__).resolve().parents[2]
WAIT_S = 10.0
PACKAGES = {
    "jax": dict(remote=jax_remote, errors=jax_errors, request=jax_request),
    "port": dict(remote=port_remote, errors=port_errors, request=port_request),
}


def _refusals(errors):
    return {
        "shed": errors.RequestShed(("encode", 12), 7, 8, retry_after_s=0.125),
        "shed_no_hint": errors.RequestShed("hit", 3, 3),
        "circuit": errors.CircuitOpen(retry_after_s=0.5),
        "circuit_no_hint": errors.CircuitOpen(),
        "closed": errors.ServiceClosed("replica draining"),
        "deadline": errors.DeadlineExceeded(0.25, 0.2),
        "cold": KeyError("user 7 has no cached state: re-anchor with history="),
        "engine": RuntimeError("engine broke"),
    }


def _error_fields(exc):
    return (type(exc).__name__, str(exc), getattr(exc, "retry_after_s", None), getattr(exc, "lane", None),
            getattr(exc, "depth", None), getattr(exc, "max_depth", None))


@pytest.mark.parametrize("kind", sorted(_refusals(port_errors)))
def test_refusal_payloads_and_rebuilds_equal(kind):
    port_status, port_payload = port_remote._error_payload(_refusals(port_errors)[kind])
    jax_status, jax_payload = jax_remote._error_payload(_refusals(jax_errors)[kind])
    if kind == "engine":  # repr() of the exception names its class the same way in both
        assert port_payload["detail"] == jax_payload["detail"]
    assert (port_status, json.dumps(port_payload, default=str)) == (jax_status, json.dumps(jax_payload, default=str))
    wire = json.loads(json.dumps(port_payload, default=str))
    assert _error_fields(port_remote._rebuild_error(port_status, wire)) == _error_fields(
        jax_remote._rebuild_error(jax_status, wire)
    )


def _response(request_module, user_id, with_ids=True):
    rng = np.random.default_rng(zlib.crc32(str(user_id).encode()))
    return request_module.ScoreResponse(
        user_id=user_id, scores=rng.normal(size=6).astype(np.float32),
        item_ids=rng.integers(0, 64, 6).astype(np.int32) if with_ids else None,
        served_from="advance", served_by="cache_only", lane="encode:12", queue_wait_s=0.003,
        batch_bucket=8, generation=2, role="candidate",
    )


@pytest.mark.parametrize("with_ids", [True, False], ids=["retrieval", "full"])
def test_response_payload_round_trips_alike(with_ids):
    port_payload = port_remote._response_payload(_response(port_request, "u1", with_ids))
    jax_payload = jax_remote._response_payload(_response(jax_request, "u1", with_ids))
    assert json.dumps(port_payload) == json.dumps(jax_payload)
    port_back, jax_back = port_remote._rebuild_response(jax_payload), jax_remote._rebuild_response(port_payload)
    for field in ("user_id", "served_from", "served_by", "lane", "queue_wait_s", "batch_bucket", "generation", "role"):
        assert getattr(port_back, field) == getattr(jax_back, field)
    np.testing.assert_array_equal(port_back.scores, jax_back.scores)
    if with_ids:
        np.testing.assert_array_equal(port_back.item_ids, jax_back.item_ids)


class ScriptedService:
    """A replica whose answer is chosen by its user id: a refusal kind from
    :func:`_refusals`, else a response."""

    def __init__(self, mods):
        self.mods = mods
        self.refusals = _refusals(mods["errors"])
        self.traces = []

    def start(self):
        return self

    def close(self):
        pass

    def heartbeat(self):
        return {"live": True, "queued": 1, "max_depth": 16, "breaker_state": "closed", "requests": 5, "errors": 1}

    def stats(self):
        return {"requests": 5, "answered": 4, "served_from": {"hit": 3, "advance": 1}}

    def submit(self, user_id, **kwargs):
        self.traces.append(kwargs.get("_trace"))
        future = Future()
        if user_id in self.refusals:
            future.set_exception(self.refusals[user_id])
        else:
            future.set_result(_response(self.mods["request"], user_id, kwargs.get("k") is not None))
        return future


@pytest.fixture(scope="module")
def servers():
    started = {}
    try:
        for name, mods in PACKAGES.items():
            service = ScriptedService(mods)
            started[name] = (mods["remote"].ReplicaServer(service, request_timeout_s=WAIT_S).start(), service)
        yield started
    finally:
        for server, _ in started.values():
            server.close()


@pytest.mark.parametrize("direction", ["jax_server-port_client", "port_server-jax_client"])
@pytest.mark.parametrize("kind", ["answer", "answer_top_k", *sorted(_refusals(port_errors))])
def test_the_wire_works_both_ways(servers, direction, kind):
    server_pkg, client_pkg = ("jax", "port") if direction.startswith("jax") else ("port", "jax")
    server, service = servers[server_pkg]
    client = PACKAGES[client_pkg]["remote"].RemoteReplica(server.address, request_timeout_s=WAIT_S).start()
    try:
        user = "u7" if kind.startswith("answer") else kind
        trace = {"trace_id": f"t-{kind}", "span_id": "s1", "parent_id": None}
        future = client.submit(user, history=[1, 2, 3], k=6 if kind == "answer_top_k" else None, _trace=trace)
        if kind.startswith("answer"):
            got = future.result(timeout=WAIT_S)
            want = _response(PACKAGES[client_pkg]["request"], "u7", kind == "answer_top_k")
            np.testing.assert_array_equal(got.scores, want.scores)
            assert (got.role, got.generation, got.served_by) == ("candidate", 2, "cache_only")
            assert isinstance(got, PACKAGES[client_pkg]["request"].ScoreResponse)
        else:
            with pytest.raises(Exception) as caught:  # noqa: PT011 — the type is checked against the local taxonomy
                future.result(timeout=WAIT_S)
            original = _refusals(PACKAGES[client_pkg]["errors"])[kind]
            # what crossed the wire is the refusal rebuilt from its payload (a
            # lane tuple travels as its str), whichever package sent it
            client_remote = PACKAGES[client_pkg]["remote"]
            expected = client_remote._rebuild_error(*client_remote._error_payload(original))
            assert _error_fields(caught.value) == _error_fields(expected)
            assert type(caught.value) is type(original)
            assert getattr(caught.value, "retry_after_s", None) == getattr(original, "retry_after_s", None)
        assert service.traces[-1] == trace
        assert client.heartbeat() == service.heartbeat()
        assert client.stats() == service.stats()
    finally:
        client.close()


def test_a_closed_client_and_a_dead_address_fail_with_service_closed():
    client = port_remote.RemoteReplica("http://127.0.0.1:9")
    with pytest.raises(port_errors.ServiceClosed, match="not running"):
        client.submit(1).result(timeout=WAIT_S)
    client.start()
    try:
        with pytest.raises(port_errors.ServiceClosed, match="unreachable"):
            client.submit(1).result(timeout=WAIT_S)
        with pytest.raises(OSError):
            client.heartbeat()
    finally:
        client.close()


def test_the_demo_server_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_remote.main(["--portfile", str(tmp_path / "port")])
    assert not (tmp_path / "port").exists()
    service = port_remote._build_demo_service(64, 12, 8, 1, 16, 2.0, device="cpu")
    assert service.engine.device.type == "cpu" and service._model.use_flash is True


@pytest.fixture(scope="module")
def killed_server(tmp_path_factory):
    """One spawned demo server: answered, scraped, then SIGKILLed."""
    run_dir = tmp_path_factory.mktemp("fleet_run")
    server = port_remote.ReplicaServerProcess(
        env=clean_cpu_env(repo_root=str(REPO)),
        args=["--device", "cpu", "--num-items", "64", "--seq-len", "12", "--embedding-dim", "8", "--num-blocks", "1"],
        startup_timeout_s=60.0, flight_path=str(run_dir / "flight.s0.ring"), metrics_port=0,
    )
    assert server.spawn(wait=True).address.startswith("http://127.0.0.1:")
    remote = port_remote.RemoteReplica(server, request_timeout_s=WAIT_S, heartbeat_timeout_s=2.0)
    fleet = ServingFleet({"s0": remote}, heartbeat_interval_s=None, hedge_ms=0, heartbeat_misses=3)
    record = {"run_dir": str(run_dir), "server": server}
    try:
        with fleet:
            fleet.poll()
            record["health_before"] = fleet.health()["s0"]
            record["answers"] = [fleet.score(user, history=[1, 2, 3, user % 64], timeout=WAIT_S) for user in range(6)]
            record["hit"] = fleet.score(2, timeout=WAIT_S)
            with urllib.request.urlopen(f"{server.metrics_url}/snapshot", timeout=WAIT_S) as reply:
                record["snapshot"] = json.loads(reply.read())
            record["launches"], record["server_stats"] = remote.launches(), remote.stats()
            KillAtStep(pid=server.pid).fire()
            record["rc"] = server.proc.wait(timeout=WAIT_S)
            after = fleet.submit(3)
            try:
                after.result(timeout=WAIT_S)
            except Exception as exc:  # noqa: BLE001 — the refusal is what is checked
                record["after_kill"] = exc
            for _ in range(3):
                fleet.poll()
            record["health_after"] = fleet.health()["s0"]
            refused = fleet.submit(4)
            try:
                refused.result(timeout=WAIT_S)
            except Exception as exc:  # noqa: BLE001 — the refusal is what is checked
                record["after_death"] = exc
            record["stats"] = fleet.stats()
        yield record
    finally:
        server.terminate()


def test_a_spawned_server_answers_then_dies_by_sigkill(killed_server):
    assert killed_server["health_before"] == "healthy"
    answers = killed_server["answers"]
    assert [r.replica for r in answers] == ["s0"] * 6 and {r.served_by for r in answers} == {"primary"}
    assert all(r.scores.shape == (64,) and np.isfinite(r.scores).all() for r in answers)
    assert killed_server["hit"].served_from == "hit"
    np.testing.assert_array_equal(killed_server["hit"].scores, answers[2].scores)
    assert killed_server["snapshot"]["replay_serve_up"]["value"] == 1.0
    assert killed_server["rc"] == -9
    # the transport death is a taxonomy refusal; once declared dead, the
    # fleet has nowhere to go
    assert isinstance(killed_server["after_kill"], port_errors.ServiceClosed)
    assert "unreachable" in str(killed_server["after_kill"])
    assert killed_server["health_after"] == "dead" and killed_server["stats"]["failovers"] == 1
    assert isinstance(killed_server["after_death"], port_errors.NoHealthyReplica)


def test_a_spawned_server_answers_its_encodes_and_launches(killed_server):
    # on the CPU the demo service runs K4's plain version and captures no
    # graph: its encode batches count, its kernel launches stay at 0
    launches = killed_server["launches"]
    assert launches == {
        "flash_attention": 0, "flash_attention_tiled": 0, "warmups": 0,
        "encode_calls": killed_server["server_stats"]["engine"]["encode_calls"],
    }
    assert launches["encode_calls"] >= 1


def test_the_port_server_answers_launches_and_the_jax_server_does_not(servers):
    # a service without a scoring engine: the kernel counts alone
    port_client = port_remote.RemoteReplica(servers["port"][0].address, request_timeout_s=WAIT_S).start()
    jax_client = port_remote.RemoteReplica(servers["jax"][0].address, request_timeout_s=WAIT_S).start()
    try:
        assert port_client.launches() == {"flash_attention": 0, "flash_attention_tiled": 0}
        with pytest.raises(RuntimeError, match="answered 404"):
            jax_client.launches()
    finally:
        port_client.close()
        jax_client.close()


def test_the_killed_servers_ring_and_postmortem_read_alike(killed_server):
    ring = os.path.join(killed_server["run_dir"], "flight.s0.ring")
    port, jax = port_blackbox.read_flight(ring), jax_blackbox.read_flight(ring)
    assert port.records == jax.records and port.last_seqno == jax.last_seqno > 0
    events = [r.get("event") for r in port.records]
    assert events[0] == "flight_open" and "on_serve_batch" in events and "on_serve_end" not in events
    post = port_postmortem.build_postmortem(killed_server["run_dir"])
    assert post == jax_postmortem.build_postmortem(killed_server["run_dir"])
    assert port_postmortem.render_postmortem(post) == jax_postmortem.render_postmortem(post)
    assert post["processes"]["s0"]["flight_records_recovered"] == len(port.records)
