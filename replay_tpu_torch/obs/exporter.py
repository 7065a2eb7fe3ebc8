"""Scrapeable metrics endpoint: stdlib HTTP, Prometheus text + JSON snapshot.

The network half of the live metrics plane (:mod:`replay_tpu_torch.obs.metrics`).
One daemon thread runs a ``ThreadingHTTPServer`` (each scrape is answered on
its own short-lived thread, so a slow scraper never blocks the next one):

* ``GET /metrics``  — Prometheus text exposition format, rendered in one pass
  under the registry lock (no torn lines, counters monotone across scrapes);
* ``GET /snapshot`` — the full registry as JSON, including histogram quantile
  estimates (the artifact CI uploads), plus a reserved ``__identity__`` block
  (``process_index``/``pid``/``start_unix``) so a federation scraper
  (``obs.federate``) or a post-mortem can label and age every scrape;
* ``GET /healthz``  — liveness probe. Plain ``ok`` by default (the shape
  existing probes assert on); with ``?format=json`` or an
  ``Accept: application/json`` header it returns the structured health
  document a remote fleet monitor needs to drive ``ReplicaHealth`` from a
  pure scrape — the live bit, lane depth vs the configured bound, breaker
  state and the windowed error-rate inputs — produced by the
  ``health_source`` callable (e.g. ``ScoringService.heartbeat``). Without a
  source the JSON document is just ``{"live": true}``; a raising source
  answers 503 with ``{"live": false, "error": ...}`` rather than hiding the
  failure behind a happy 200.

Failure posture: a metrics endpoint must never take down what it observes.
A busy port (or any bind error) logs one warning and degrades the exporter
to a no-op — ``port`` is then ``None`` and :meth:`MetricsExporter.close` is
safe to call regardless. ``port=0`` binds an ephemeral port (tests, and
multi-process runs where a fixed port would collide on one host) and
exposes the chosen one via :attr:`MetricsExporter.port`.

Copied from ``replay_tpu/obs/exporter.py`` (host-only). Started and stopped
by ``Trainer.fit(metrics_port=...)``; usable standalone around any
:class:`~replay_tpu_torch.obs.metrics.MetricsRegistry`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from .metrics import MetricsRegistry

logger = logging.getLogger("replay_tpu_torch")

__all__ = ["MetricsExporter"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    # the registry is attached to the server instance by MetricsExporter
    server: "_Server"

    def _respond(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            path, _, query = self.path.partition("?")
            if path in ("/metrics", "/"):
                body = self.server.registry.render_prometheus().encode()
                self._respond(200, PROMETHEUS_CONTENT_TYPE, body)
            elif path == "/snapshot":
                snapshot = self.server.registry.snapshot()
                # identity rides under a reserved non-metric key so the
                # federation scraper and the post-mortem report can label and
                # age every scrape without a second round trip
                snapshot["__identity__"] = self.server.identity
                body = json.dumps(snapshot, indent=2, default=str).encode()
                self._respond(200, "application/json", body)
            elif path == "/healthz":
                wants_json = "format=json" in query or "application/json" in (
                    self.headers.get("Accept") or ""
                )
                if wants_json:
                    self._respond_health_json()
                else:
                    self._respond(200, "text/plain", b"ok\n")
            else:
                self._respond(404, "text/plain", b"not found\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper hung up mid-response; nothing to salvage

    def _respond_health_json(self) -> None:
        source = self.server.health_source
        try:
            health: Dict[str, Any] = {"live": True}
            if source is not None:
                health = dict(source())
        except Exception as exc:  # noqa: BLE001 — a broken source IS the signal
            body = json.dumps(
                {"live": False, "error": repr(exc), **self.server.identity}
            ).encode()
            self._respond(503, "application/json", body)
            return
        for key, value in self.server.identity.items():
            health.setdefault(key, value)  # the source's own fields win
        body = json.dumps(health, default=str).encode()
        self._respond(200, "application/json", body)

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        pass  # scrape-cadence request lines must not spam the run's stderr


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a scrape can race a restart on the same port in tests: reuse avoids
    # TIME_WAIT flakes without masking a genuinely-owned port (bind on a port
    # another LISTENING server holds still fails)
    allow_reuse_address = True
    registry: MetricsRegistry
    health_source: Optional[Callable[[], Dict[str, Any]]]
    identity: Dict[str, Any]


class MetricsExporter:
    """Serve a registry over HTTP from a background daemon thread.

    >>> registry = MetricsRegistry()
    >>> exporter = MetricsExporter(registry, port=0).start()
    >>> exporter.port is not None  # ephemeral port bound
    True
    >>> exporter.close()
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 9100,
        host: str = "127.0.0.1",
        health_source: Optional[Callable[[], Dict[str, Any]]] = None,
        identity: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.registry = registry
        self.requested_port = int(port)
        self.host = host
        self.health_source = health_source
        # who answers this port: the identity block /snapshot and /healthz
        # carry so a federation scraper (or a post-mortem) can label every
        # scrape with the process it came from and age it by start time
        self.identity: Dict[str, Any] = {
            "process_index": int(os.environ.get("REPLAY_TPU_PROCESS_ID", 0) or 0),
            "pid": os.getpid(),
            "start_unix": time.time(),
        }
        if identity:
            self.identity.update(identity)
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port, or ``None`` when the exporter is not serving
        (never started, bind failed, or closed)."""
        return self._server.server_address[1] if self._server is not None else None

    @property
    def url(self) -> Optional[str]:
        bound = self.port
        return f"http://{self.host}:{bound}" if bound is not None else None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        try:
            server = _Server((self.host, self.requested_port), _Handler)
        except OSError as exc:
            # the no-op degradation: a second trainer on the host, a stale
            # process holding the port — the run continues unobserved rather
            # than dead
            logger.warning(
                "metrics exporter: cannot bind %s:%s (%s); metrics will not be served",
                self.host, self.requested_port, exc,
            )
            return self
        server.registry = self.registry
        server.health_source = self.health_source
        server.identity = self.identity
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        logger.info("metrics exporter serving on %s", self.url)
        return self

    def set_registry(self, registry: MetricsRegistry) -> None:
        """Swap the served registry atomically (the federation scraper builds
        a fresh merged registry per pass). In-flight requests finish against
        whichever registry they resolved — both are internally consistent."""
        self.registry = registry
        if self._server is not None:
            self._server.registry = registry

    def close(self) -> None:
        server, thread = self._server, self._thread
        self._server, self._thread = None, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.close()
