"""Socket-boundary replicas: the fleet's duck-typed surface over real HTTP.

Copied from ``replay_tpu/serve/remote.py``, wire format and all: the same
JSON payloads, the same HTTP status for each refusal, ``retry_after_s`` kept,
so a client of either package talks to a server of the other. The fleet's
routing, failover, hedging, backoff and drain (``serve/fleet.py``) run
unchanged over a process boundary:

* :class:`ReplicaServer` gives one :class:`~replay_tpu_torch.serve.ScoringService`
  its own HTTP front in its own OS process — ``POST /score`` (blocking
  request/response), ``GET /healthz`` (the structured heartbeat document,
  the same shape :mod:`replay_tpu_torch.obs.exporter` serves under
  ``?format=json``) and ``GET /stats``. The serve-error taxonomy maps onto
  HTTP statuses (shed → 429, breaker/closed → 503, deadline → 504, cold
  re-anchor → 404) so WHY a request was refused — and ``retry_after_s`` —
  survives the wire.

* :class:`RemoteReplica` is the client half: the exact
  ``submit/score/heartbeat/stats/start/close`` surface
  :class:`~replay_tpu_torch.serve.ServingFleet` duck-types over, so the
  router/failover/hedge/drain machinery runs UNCHANGED above it. Refusal
  payloads are reconstructed into the same exception types
  (:class:`~replay_tpu_torch.serve.errors.RequestShed` with its ``retry_after_s``
  intact, etc.); transport failures — connection refused, reset, timeout:
  what a SIGKILLed server process actually produces — surface as
  :class:`~replay_tpu_torch.serve.errors.ServiceClosed`, the retryable refusal
  that sends the router shopping downstream while heartbeat misses declare
  the replica dead. ``heartbeat()`` is a pure remote scrape of
  ``/healthz?format=json``: the monitor drives ``ReplicaHealth`` from the
  live bit, lane depth, breaker state and windowed error-rate gauges of a
  process it shares no memory with.

* :class:`ReplicaServerProcess` spawns ``python -m replay_tpu_torch.serve.remote``
  (a small demo SasRec service on kernel K4, ``--device cuda`` unless the
  arguments ask for ``--device cpu``) and handshakes the ephemeral
  port through a portfile — the server binds port 0 and PUBLISHES the bound
  address; nothing is hardcoded, so N servers and N test sessions coexist
  on one host. ``respawn()`` restarts a SIGKILLed server on a FRESH port;
  :attr:`address` re-reads the portfile, so a :class:`RemoteReplica` built
  over the process object follows the replica across restarts.

Used by ``tests/_torch/test_torch_remote.py`` (both directions of the wire,
a SIGKILLed server) and the ``fleet`` phase of ``chip_smoke.py`` (socket chaos
with server processes on the card, each with its own CUDA context).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Hashable, Optional, Sequence

import numpy as np

from .errors import (
    CircuitOpen,
    DeadlineExceeded,
    RequestShed,
    ServiceClosed,
)
from .futures import safe_fail, safe_set_result
from .request import ScoreResponse

logger = logging.getLogger("replay_tpu_torch")

__all__ = ["RemoteReplica", "ReplicaServer", "ReplicaServerProcess"]


# -- taxonomy <-> HTTP ------------------------------------------------------- #
def _error_payload(exc: BaseException) -> tuple:
    """(status, payload) for one refusal: enough fields ride the wire that
    the client reconstructs the SAME exception, hints intact."""
    if isinstance(exc, RequestShed):
        return 429, {
            "error": "RequestShed",
            "lane": str(exc.lane),
            "depth": exc.depth,
            "max_depth": exc.max_depth,
            "retry_after_s": exc.retry_after_s,
        }
    if isinstance(exc, CircuitOpen):
        return 503, {"error": "CircuitOpen", "retry_after_s": exc.retry_after_s}
    if isinstance(exc, ServiceClosed):
        return 503, {"error": "ServiceClosed", "detail": str(exc)}
    if isinstance(exc, DeadlineExceeded):
        return 504, {
            "error": "DeadlineExceeded",
            "waited_s": exc.waited_s,
            "deadline_s": exc.deadline_s,
        }
    if isinstance(exc, KeyError):
        # the cold-reanchor contract: an interaction that cannot land on a
        # cold cache refuses loudly — a distinct status, not a 500
        return 404, {"error": "KeyError", "detail": str(exc.args[0]) if exc.args else ""}
    return 500, {"error": type(exc).__name__, "detail": repr(exc)}


def _rebuild_error(status: int, payload: Dict[str, Any]) -> BaseException:
    kind = payload.get("error")
    if kind == "RequestShed":
        return RequestShed(
            payload.get("lane"),
            int(payload.get("depth") or 0),
            int(payload.get("max_depth") or 0),
            retry_after_s=payload.get("retry_after_s"),
        )
    if kind == "CircuitOpen":
        return CircuitOpen(retry_after_s=payload.get("retry_after_s"))
    if kind == "ServiceClosed":
        return ServiceClosed(payload.get("detail") or "service is not running")
    if kind == "DeadlineExceeded":
        return DeadlineExceeded(
            float(payload.get("waited_s") or 0.0),
            float(payload.get("deadline_s") or 0.0),
        )
    if kind == "KeyError":
        return KeyError(payload.get("detail") or "cold cache")
    return RuntimeError(payload.get("detail") or f"replica error (HTTP {status})")


def _response_payload(response: ScoreResponse) -> Dict[str, Any]:
    return {
        "user_id": response.user_id,
        "scores": np.asarray(response.scores).tolist(),
        "item_ids": (
            np.asarray(response.item_ids).tolist()
            if response.item_ids is not None
            else None
        ),
        "served_from": response.served_from,
        "served_by": response.served_by,
        "lane": response.lane,
        "queue_wait_s": response.queue_wait_s,
        "batch_bucket": response.batch_bucket,
        "generation": response.generation,
        "role": response.role,
    }


def _rebuild_response(payload: Dict[str, Any]) -> ScoreResponse:
    return ScoreResponse(
        user_id=payload["user_id"],
        scores=np.asarray(payload["scores"], np.float32),
        item_ids=(
            np.asarray(payload["item_ids"], np.int32)
            if payload.get("item_ids") is not None
            else None
        ),
        served_from=payload["served_from"],
        served_by=payload.get("served_by", "primary"),
        lane=payload.get("lane", ""),
        queue_wait_s=float(payload.get("queue_wait_s") or 0.0),
        batch_bucket=int(payload.get("batch_bucket") or 0),
        generation=int(payload.get("generation") or 0),
        role=payload.get("role", "stable"),
    )


# -- server ------------------------------------------------------------------ #
class _ReplicaHandler(BaseHTTPRequestHandler):
    server: "_ReplicaHTTPServer"
    protocol_version = "HTTP/1.1"  # keep-alive: one client socket, N requests

    def _respond(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            path, _, _ = self.path.partition("?")
            if path == "/healthz":
                # same document the exporter's /healthz?format=json serves:
                # a raising heartbeat answers 503, never a happy 200
                try:
                    self._respond(200, dict(self.server.service.heartbeat()))
                except Exception as exc:  # noqa: BLE001 — the signal itself
                    self._respond(503, {"live": False, "error": repr(exc)})
            elif path == "/stats":
                try:
                    self._respond(200, dict(self.server.service.stats()))
                except Exception as exc:  # noqa: BLE001
                    self._respond(500, {"error": type(exc).__name__, "detail": repr(exc)})
            elif path == "/launches":
                self._respond(200, self.server.launches())
            else:
                self._respond(404, {"error": "not found"})
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-response

    def do_POST(self) -> None:  # noqa: N802
        try:
            path, _, _ = self.path.partition("?")
            if path != "/score":
                self._respond(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length") or 0)
            request = json.loads(self.rfile.read(length) or b"{}")
            try:
                future = self.server.service.submit(
                    request["user_id"],
                    history=request.get("history"),
                    new_items=tuple(request.get("new_items") or ()),
                    k=request.get("k"),
                    candidates=request.get("candidates"),
                    deadline_ms=request.get("deadline_ms"),
                    _trace=request.get("_trace"),
                )
                # block THIS handler thread (ThreadingHTTPServer: one thread
                # per connection) — the socket analog of Future.result(). The
                # wait is bounded: the service's own deadline/close paths
                # resolve every future, plus a transport-level backstop
                timeout = self.server.request_timeout_s
                deadline_ms = request.get("deadline_ms")
                if deadline_ms is not None:
                    timeout = max(float(deadline_ms) / 1000.0 + 5.0, 5.0)
                response = future.result(timeout=timeout)
            except Exception as exc:  # noqa: BLE001 — mapped, not masked
                status, payload = _error_payload(exc)
                self._respond(status, payload)
                return
            self._respond(200, _response_payload(response))
        except (BrokenPipeError, ConnectionResetError):
            pass

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        pass  # request-rate log lines must not spam the replica's stderr


def _launch_counts(service: Any) -> Dict[str, int]:
    """This process's attention-kernel launches (``ops/counts.py``: eager
    and through graph replays) and, where ``service`` has a scoring engine,
    its encode batches and capture warm-ups (each warm-up launches every
    kernel of its program once)."""
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled

    counted = {"flash_attention": flash_attention.launches, "flash_attention_tiled": flash_attention_tiled.launches}
    engine = getattr(service, "engine", None)
    if engine is not None:
        counted["encode_calls"] = engine.encode_calls
        counted["warmups"] = engine.graph_counts()["encode"]["warmups"]
    return counted


class _ReplicaHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    service: Any
    request_timeout_s: float
    at_start: Dict[str, int]

    def launches(self) -> Dict[str, int]:
        """:func:`_launch_counts` since the server started taking requests."""
        now = _launch_counts(self.service)
        return {name: count - self.at_start[name] for name, count in now.items()}


class ReplicaServer:
    """One scoring service behind a real HTTP socket.

    Binds ``port`` (default 0 → OS-chosen, published via :attr:`port` /
    :attr:`address` and optionally a ``portfile``) and serves until
    :meth:`close`. The handler threads block inside ``Future.result`` while
    the service's micro-batcher does the device work — the same no-hung-
    requests contract as in-process, now observable only through the socket.

    Beyond the JAX package's wire, ``GET /launches`` answers the kernel
    launches, encode batches and capture warm-ups counted in this process
    since :meth:`start` (:meth:`RemoteReplica.launches`): what shows that a
    server's requests ran on the card's kernels.
    """

    def __init__(
        self,
        service: Any,
        port: int = 0,
        host: str = "127.0.0.1",
        request_timeout_s: float = 120.0,
        portfile: Optional[str] = None,
    ) -> None:
        self.service = service
        self.host = host
        self.portfile = portfile
        self._server = _ReplicaHTTPServer((host, int(port)), _ReplicaHandler)
        self._server.service = service
        self._server.request_timeout_s = float(request_timeout_s)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ReplicaServer":
        if self._thread is not None:
            return self
        self._server.at_start = _launch_counts(self.service)
        self.service.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="replica-server",
            daemon=True,
        )
        self._thread.start()
        if self.portfile:
            # atomic publish: a reader never sees a half-written port
            tmp = f"{self.portfile}.tmp"
            with open(tmp, "w") as fh:
                fh.write(self.address)
            os.replace(tmp, self.portfile)
            exporter = getattr(self.service, "metrics_exporter", None)
            if exporter is not None and exporter.url is not None:
                # the ephemeral metrics port, published the same atomic way,
                # so a federation scraper (obs.federate) can find every
                # replica's /snapshot without a fixed-port convention
                tmp = f"{self.portfile}.metrics.tmp"
                with open(tmp, "w") as fh:
                    fh.write(exporter.url)
                os.replace(tmp, f"{self.portfile}.metrics")
        logger.info("replica server on %s", self.address)
        return self

    def serve_forever(self) -> None:
        """Start and park the calling thread until SIGTERM/SIGINT (the
        ``python -m replay_tpu_torch.serve.remote`` main loop). SIGKILL, of
        course, never reaches this — that is the point of the chaos tests."""
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
        self.start()
        stop.wait()
        self.close()

    def close(self) -> None:
        thread, self._thread = self._thread, None
        if thread is not None:
            self._server.shutdown()
            thread.join(timeout=5.0)
        self._server.server_close()
        self.service.close()


# -- client ------------------------------------------------------------------ #
class RemoteReplica:
    """The fleet-facing client for one :class:`ReplicaServer`.

    :param target: the server's base address (``http://host:port``) or any
        object with an ``.address`` attribute (a
        :class:`ReplicaServerProcess`) — resolved PER REQUEST, so a respawned
        server on a fresh port is picked up without rebuilding the fleet.
    :param max_connections: worker threads doing the blocking HTTP calls
        (the client-side analog of the service's handler threads).
    :param heartbeat_timeout_s: the /healthz scrape budget. A dead process
        answers with connection-refused inside one kernel round-trip, so the
        monitor's miss accounting stays on its own cadence.
    """

    def __init__(
        self,
        target: Any,
        max_connections: int = 8,
        request_timeout_s: float = 120.0,
        heartbeat_timeout_s: float = 2.0,
    ) -> None:
        self._target = target
        self.request_timeout_s = float(request_timeout_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._max_connections = int(max_connections)
        self._pool: Optional[Any] = None
        self._lock = threading.Lock()

    @property
    def address(self) -> str:
        address = getattr(self._target, "address", self._target)
        return str(address).rstrip("/")

    # -- the ScoringService duck-typed surface ------------------------------ #
    def start(self) -> "RemoteReplica":
        from concurrent.futures import ThreadPoolExecutor

        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_connections,
                    thread_name_prefix="remote-replica",
                )
        return self

    def close(self) -> None:
        """Client-side only: the server process's lifecycle belongs to
        whoever spawned it (:class:`ReplicaServerProcess`/the operator) —
        a fleet closing must not take down a replica other fleets share."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def submit(
        self,
        user_id: Hashable,
        history: Optional[Sequence[int]] = None,
        new_items: Sequence[int] = (),
        k: Optional[int] = None,
        candidates: Optional[Sequence[int]] = None,
        deadline_ms: Optional[float] = None,
        _role: Optional[str] = None,
        _trace: Optional[dict] = None,
    ) -> "Future[ScoreResponse]":
        """Never blocks, never hangs: the POST runs on a pool thread; every
        failure mode — taxonomy refusal, transport death, closed client —
        fails the future with a real exception."""
        future: "Future[ScoreResponse]" = Future()
        body = {
            "user_id": user_id,
            "history": list(history) if history is not None else None,
            "new_items": list(new_items),
            "k": k,
            "candidates": list(candidates) if candidates is not None else None,
            "deadline_ms": deadline_ms,
            "_trace": _trace,
        }
        with self._lock:
            pool = self._pool
        if pool is None:
            safe_fail(future, ServiceClosed("remote replica client is not running"))
            return future
        try:
            pool.submit(self._score_worker, future, body)
        except RuntimeError:  # pool shut down between the check and submit
            safe_fail(future, ServiceClosed("remote replica client is not running"))
        return future

    def _score_worker(self, future: "Future[ScoreResponse]", body: Dict[str, Any]) -> None:
        # honor a fleet-side cancel (a hedge's losing twin) before paying for
        # the HTTP round trip — the socket analog of the batch build
        # skipping cancelled waiters
        if not future.set_running_or_notify_cancel():
            return
        timeout = self.request_timeout_s
        if body.get("deadline_ms") is not None:
            timeout = max(float(body["deadline_ms"]) / 1000.0 + 10.0, 10.0)
        try:
            status, payload = self._http_json(
                "POST", "/score", body=body, timeout=timeout
            )
        except Exception as exc:  # noqa: BLE001 — transport death
            # connection refused/reset/timeout: what a SIGKILLed server
            # actually looks like from here. ServiceClosed is the retryable
            # refusal that sends the router downstream while heartbeat
            # misses do the declaring
            safe_fail(
                future,
                ServiceClosed(f"replica at {self.address} unreachable: {exc!r}"),
            )
            return
        if status == 200:
            safe_set_result(future, _rebuild_response(payload))
        else:
            safe_fail(future, _rebuild_error(status, payload))

    def score(self, user_id, timeout: Optional[float] = 60.0, **kwargs) -> ScoreResponse:
        if timeout is not None and "deadline_ms" not in kwargs:
            kwargs["deadline_ms"] = timeout * 1000.0
        return self.submit(user_id, **kwargs).result(timeout=timeout)

    def heartbeat(self) -> Dict[str, Any]:
        """A pure remote scrape: the health document the fleet monitor feeds
        to ``ReplicaHealth`` comes off the wire, not out of shared memory.
        Raises on ANY transport failure — the monitor counts the miss."""
        status, payload = self._http_json(
            "GET", "/healthz?format=json", timeout=self.heartbeat_timeout_s
        )
        if status != 200:
            # a 503 heartbeat ({"live": false, ...}) is still a document:
            # the monitor reads live=False and counts the miss itself
            return payload if isinstance(payload, dict) else {"live": False}
        return payload

    def stats(self) -> Dict[str, Any]:
        status, payload = self._http_json("GET", "/stats", timeout=self.request_timeout_s)
        if status != 200:
            raise RuntimeError(f"replica /stats answered {status}: {payload}")
        return payload

    def launches(self) -> Dict[str, int]:
        """The server's ``GET /launches``: its kernel launches, encode
        batches and capture warm-ups since it started taking requests (a
        server of this package only)."""
        status, payload = self._http_json("GET", "/launches", timeout=self.request_timeout_s)
        if status != 200:
            raise RuntimeError(f"replica /launches answered {status}: {payload}")
        return payload

    # -- transport ----------------------------------------------------------- #
    def _http_json(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        timeout: float = 30.0,
    ) -> tuple:
        data = json.dumps(body).encode() if body is not None else None
        request = urllib.request.Request(
            f"{self.address}{path}",
            data=data,
            method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(request, timeout=timeout) as reply:
                return reply.status, json.loads(reply.read() or b"{}")
        except urllib.error.HTTPError as exc:
            # a taxonomy status with a JSON body is an ANSWER, not transport
            # death — read it through
            payload = exc.read()
            try:
                return exc.code, json.loads(payload or b"{}")
            except ValueError:
                return exc.code, {"error": "http", "detail": payload.decode(errors="replace")}


# -- process spawning -------------------------------------------------------- #
class ReplicaServerProcess:
    """Spawn ``python -m replay_tpu_torch.serve.remote`` as a real OS process and
    handshake its ephemeral port through a portfile.

    The argv/env carry NO port: the server binds 0 and publishes. A CPU
    test passes ``args=["--device", "cpu", ...]`` and an ``env`` from
    :func:`replay_tpu_torch.parallel.launch.clean_cpu_env` (no card visible,
    one compute thread); on the card the servers share it, each with a CUDA
    context of its own, which a SIGKILL frees.
    """

    def __init__(
        self,
        env: Optional[Dict[str, str]] = None,
        args: Sequence[str] = (),
        python: str = sys.executable,
        startup_timeout_s: float = 120.0,
        flight_path: Optional[str] = None,
        metrics_port: Optional[int] = None,
    ) -> None:
        self._env = dict(env) if env is not None else dict(os.environ)
        self._args = [str(a) for a in args]
        if flight_path is not None:
            self._args += ["--flight-path", str(flight_path)]
        if metrics_port is not None:
            self._args += ["--metrics-port", str(metrics_port)]
        self.flight_path = flight_path
        self._python = python
        self._startup_timeout_s = float(startup_timeout_s)
        self._dir = tempfile.mkdtemp(prefix="replica_server_")
        self.portfile = os.path.join(self._dir, "port")
        self.proc: Optional[subprocess.Popen] = None
        self._spool = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    @property
    def address(self) -> str:
        with open(self.portfile) as fh:
            return fh.read().strip()

    @property
    def metrics_url(self) -> Optional[str]:
        """The replica's published metrics exporter URL (``--metrics-port``),
        or ``None`` before the server wrote ``<portfile>.metrics``."""
        try:
            with open(f"{self.portfile}.metrics") as fh:
                return fh.read().strip()
        except OSError:
            return None

    def spawn(self, wait: bool = True) -> "ReplicaServerProcess":
        """Start the server process. ``wait=False`` returns immediately so N
        replicas can compile their engines concurrently; follow with
        :meth:`wait_ready` before using :attr:`address`."""
        if self.proc is not None and self.proc.poll() is None:
            return self
        if os.path.exists(self.portfile):
            os.unlink(self.portfile)  # a respawn must publish a FRESH port
        self._spool = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [
                self._python,
                "-m",
                "replay_tpu_torch.serve.remote",
                "--portfile",
                self.portfile,
                *self._args,
            ],
            env=self._env,
            stdout=self._spool,
            stderr=self._spool,
        )
        return self.wait_ready() if wait else self

    def wait_ready(self) -> "ReplicaServerProcess":
        deadline = time.monotonic() + self._startup_timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(self.portfile):
                return self
            if self.proc is None or self.proc.poll() is not None:
                rc = self.proc.returncode if self.proc is not None else None
                raise RuntimeError(
                    f"replica server died during startup (rc={rc}):\n"
                    f"{self.output()[-2000:]}"
                )
            time.sleep(0.05)
        self.terminate()
        raise RuntimeError(
            f"replica server did not publish a port within "
            f"{self._startup_timeout_s:.0f}s:\n{self.output()[-2000:]}"
        )

    def respawn(self) -> "ReplicaServerProcess":
        """Bring a (SIGKILLed) server back — on a fresh ephemeral port; a
        :class:`RemoteReplica` holding this object follows automatically."""
        return self.spawn()

    def output(self) -> str:
        if self._spool is None:
            return ""
        self._spool.seek(0)
        return self._spool.read().decode(errors="replace")

    def terminate(self, timeout_s: float = 10.0) -> Optional[int]:
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout_s)
        return self.proc.returncode

    def __enter__(self) -> "ReplicaServerProcess":
        return self.spawn()

    def __exit__(self, *exc_info) -> None:
        self.terminate()


# -- demo server main -------------------------------------------------------- #
DEMO_BATCH_BUCKETS = (1, 8)


def _demo_model(num_items: int, seq_len: int, embedding_dim: int, num_blocks: int, device: str, use_flash: bool = True):
    """The demo replicas' tiny SasRec: one head, no dropout, its weights
    drawn from seed 0, so that N independently-spawned servers hold IDENTICAL
    params and the fleet's parity/locality claims carry over the socket (and
    ``use_flash=False`` gives the same weights on the unfused attention)."""
    import torch

    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.sequential.sasrec import SasRec

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id",
            FeatureType.CATEGORICAL,
            is_seq=True,
            feature_hint=FeatureHint.ITEM_ID,
            cardinality=num_items,
            embedding_dim=embedding_dim,
        )
    )
    return SasRec(
        schema,
        embedding_dim=embedding_dim,
        num_blocks=num_blocks,
        num_heads=1,
        max_sequence_length=seq_len,
        dropout_rate=0.0,
        use_flash=use_flash,
        device=device,
        generator=torch.Generator().manual_seed(0),
    )


def _build_demo_service(
    num_items: int,
    seq_len: int,
    embedding_dim: int,
    num_blocks: int,
    cache_capacity: int,
    max_wait_ms: float,
    flight_path: Optional[str] = None,
    metrics_port: Optional[int] = None,
    device: str = "cuda",
):
    """The deterministic demo service every demo replica runs
    (:func:`_demo_model`, seed 0 everywhere). Its encode runs kernel K4
    (``use_flash=True``) on ``device``, which raises when it names CUDA and
    there is no card."""
    from replay_tpu_torch.serve import FallbackScorer, ScoringService

    model = _demo_model(num_items, seq_len, embedding_dim, num_blocks, device)
    popularity = np.random.default_rng(0).integers(0, num_items, size=2048)
    fallback = FallbackScorer.from_interactions(popularity, num_items)
    return ScoringService(
        model,
        model.state_dict(),
        batch_buckets=DEMO_BATCH_BUCKETS,
        max_wait_ms=max_wait_ms,
        cache_capacity=cache_capacity,
        cold_miss="fallback",
        fallback=fallback,
        flight_path=flight_path,
        metrics_port=metrics_port,
        device=device,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="demo scoring replica server")
    parser.add_argument("--portfile", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num-items", type=int, default=64)
    parser.add_argument("--seq-len", type=int, default=12)
    parser.add_argument("--embedding-dim", type=int, default=8)
    parser.add_argument("--num-blocks", type=int, default=1)
    parser.add_argument("--cache", type=int, default=512)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the service's engine runs: cuda (the default; raises "
        "without a card) or cpu",
    )
    parser.add_argument(
        "--flight-path",
        default=None,
        help="record serve events into a SIGKILL-proof flight ring here "
        "(obs.blackbox); defaults to $REPLAY_TPU_FLIGHT_PATH",
    )
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve /metrics + /snapshot on this port (0 = ephemeral, "
        "published to <portfile>.metrics for federation scrapers)",
    )
    args = parser.parse_args(argv)

    service = _build_demo_service(
        num_items=args.num_items,
        seq_len=args.seq_len,
        embedding_dim=args.embedding_dim,
        num_blocks=args.num_blocks,
        cache_capacity=args.cache,
        max_wait_ms=args.max_wait_ms,
        flight_path=args.flight_path,
        metrics_port=args.metrics_port,
        device=args.device,
    )
    ReplicaServer(service, port=args.port, portfile=args.portfile).serve_forever()


if __name__ == "__main__":
    main()
