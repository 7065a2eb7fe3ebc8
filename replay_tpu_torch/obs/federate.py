"""Fleet-wide metrics federation: N per-process exporters, ONE ``/metrics``.

Copied from ``replay_tpu/obs/federate.py`` (host-only, stdlib only): the
port's exporters serve the JAX package's ``/snapshot`` document, so one
federator merges members of either package.

Multi-process runs leave live metrics scattered: every worker and every
replica server runs its own :class:`~replay_tpu_torch.obs.exporter.MetricsExporter`
on its own ephemeral port, so "how many requests did the FLEET serve" means N
scrapes and hand-merging. This module is the live complement to
``obs.report``'s offline events-shard merge: a :class:`FleetFederator`
scrapes each member's ``/snapshot`` (the JSON view — exact bucket counts, not
the quantile estimates a Prometheus text scrape would force us to re-derive)
and folds everything into one fresh
:class:`~replay_tpu_torch.obs.metrics.MetricsRegistry`, served on a single
federated ``/metrics``.

Merge semantics, per metric kind:

* **counters** — summed across processes. The federated total equals the sum
  of the per-process totals EXACTLY (integer-valued counters add without
  error in float64), so it reconciles against each member's own accounting
  (``ScoringService.stats()``), as the service reconciles ``shed_total``.
* **gauges** — last-write-wins scalars do not add; each process's value is
  kept as its own series, labeled ``process="<index>"`` (the exporter's
  identity block names the index; the scrape order is the fallback).
* **histograms** — bucket-merged losslessly: same bounds ⇒ per-bucket counts,
  overflow, count, sum added; min/max folded. Mismatched bounds for the same
  metric are a configuration error and raise :class:`FederationError` naming
  the metric — silently resampling would fake precision. Quantiles are then
  re-estimated over the MERGED counts (estimating over per-process quantiles
  is the classic averaging-percentiles mistake).

A member that fails to answer is recorded in ``errors`` and skipped — the
federated view degrades to the reachable subset rather than erroring the
whole scrape; the ``replay_federation_members`` /
``replay_federation_errors_total`` meta-series make the coverage visible.

Stdlib-only by contract (urllib + the registry), like the exporter it feeds:
``python -m replay_tpu_torch.obs.federate http://h:p1 http://h:p2 --port 9200``
runs it standalone.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import urllib.request
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .metrics import Histogram, MetricsRegistry
from .exporter import MetricsExporter

logger = logging.getLogger("replay_tpu_torch")

__all__ = [
    "FederationError",
    "FederatedScrape",
    "FleetFederator",
    "federate_snapshots",
    "parse_metric_key",
    "scrape_snapshot",
]

_LABELS = re.compile(r'(\w+)="([^"]*)"')
IDENTITY_KEY = "__identity__"  # the exporter's non-metric identity block


class FederationError(ValueError):
    """Raised when member snapshots cannot merge exactly (e.g. the same
    histogram exported with different bucket bounds)."""


def parse_metric_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``'name{k="v",k2="v2"}'`` → ``('name', {'k': 'v', 'k2': 'v2'})`` —
    the inverse of the snapshot's key format."""
    name, brace, rest = key.partition("{")
    if not brace:
        return key, {}
    return name, dict(_LABELS.findall(rest))


def scrape_snapshot(target: str, timeout_s: float = 5.0) -> Dict[str, Any]:
    """One member's ``/snapshot`` as a dict. ``target`` is a base URL
    (``http://host:port``) or a full ``/snapshot`` URL."""
    url = target if target.endswith("/snapshot") else target.rstrip("/") + "/snapshot"
    with urllib.request.urlopen(url, timeout=timeout_s) as response:  # noqa: S310
        return json.loads(response.read().decode())


def _merge_histogram(merged: Histogram, sample: Mapping[str, Any], name: str) -> None:
    bounds = tuple(float(b) for b in sample.get("buckets", {}))
    if bounds != merged.bounds:
        msg = (
            f"histogram {name!r}: member bounds {list(bounds)} != federated "
            f"bounds {list(merged.bounds)}; exact bucket merge needs one ladder"
        )
        raise FederationError(msg)
    for i, count in enumerate(sample["buckets"].values()):
        merged.counts[i] += int(count)
    merged.counts[-1] += int(sample.get("overflow", 0))
    merged.total += int(sample["count"])
    merged.sum += float(sample["sum"])
    for attr, fold in (("min", min), ("max", max)):
        value = sample.get(attr)
        if value is not None:
            current = getattr(merged, attr)
            setattr(
                merged, attr,
                float(value) if current is None else fold(current, float(value)),
            )
    for exemplar in sample.get("exemplars", ()):
        merged._offer_exemplar(float(exemplar["value"]), str(exemplar["trace_id"]))


def federate_snapshots(
    snapshots: Sequence[Mapping[str, Any]],
    process_labels: Optional[Sequence[str]] = None,
) -> MetricsRegistry:
    """Fold N ``/snapshot`` dicts into one fresh registry (see module doc for
    the per-kind semantics). ``process_labels[i]`` names member ``i``'s gauge
    series; defaults to the member's identity ``process_index``, else ``i``."""
    registry = MetricsRegistry()
    for index, snapshot in enumerate(snapshots):
        identity = snapshot.get(IDENTITY_KEY) or {}
        if process_labels is not None and index < len(process_labels):
            process = str(process_labels[index])
        else:
            process = str(identity.get("process_index", index))
        for key, sample in snapshot.items():
            if key == IDENTITY_KEY or not isinstance(sample, Mapping):
                continue
            name, labels = parse_metric_key(key)
            kind = sample.get("type")
            if kind == "counter":
                registry.inc(name, float(sample["value"]), labels=labels)
            elif kind == "gauge":
                registry.set(
                    name, float(sample["value"]),
                    labels={**labels, "process": process},
                )
            elif kind == "histogram":
                bounds = tuple(float(b) for b in sample.get("buckets", {}))
                if not bounds:
                    continue  # an empty ladder carries nothing to merge
                # same-package privity: build/fetch the merged histogram under
                # the registry lock, then add this member's exact counts
                with registry._lock:
                    merged = registry._get(
                        name, "histogram", labels, lambda b=bounds: Histogram(b)
                    )
                    _merge_histogram(merged, sample, name)
    return registry


class FederatedScrape:
    """One federation pass: the merged registry plus per-member outcome."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.members: List[Dict[str, Any]] = []
        self.errors: Dict[str, str] = {}

    @property
    def reachable(self) -> int:
        return len(self.members)


class FleetFederator:
    """Scrape N exporters on a cadence; serve the merged view on one port.

    >>> fed = FleetFederator(["http://127.0.0.1:9100"], port=0)
    >>> scrape = fed.scrape()   # one manual pass, no server needed
    >>> fed.close()
    """

    def __init__(
        self,
        targets: Sequence[str],
        port: int = 0,
        host: str = "127.0.0.1",
        interval_s: float = 5.0,
        timeout_s: float = 5.0,
    ) -> None:
        self.targets = [str(t) for t in targets]
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._registry = MetricsRegistry()
        self.exporter = MetricsExporter(
            self._registry, port=port, host=host,
            identity={"role": "federator", "members": len(self.targets)},
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scrape(self) -> FederatedScrape:
        """One federation pass; also swaps the served registry atomically."""
        result = FederatedScrape()
        snapshots: List[Mapping[str, Any]] = []
        for target in self.targets:
            try:
                snapshot = scrape_snapshot(target, timeout_s=self.timeout_s)
            except Exception as exc:  # noqa: BLE001 — a dead member is data
                result.errors[target] = repr(exc)
                continue
            snapshots.append(snapshot)
            identity = dict(snapshot.get(IDENTITY_KEY) or {})
            identity["target"] = target
            result.members.append(identity)
        result.registry = federate_snapshots(snapshots)
        # the federation's own coverage, in the same registry it serves
        result.registry.set("replay_federation_members", float(len(self.targets)))
        result.registry.set("replay_federation_reachable", float(result.reachable))
        for target, error in result.errors.items():
            result.registry.inc(
                "replay_federation_errors_total", labels={"target": target}
            )
            logger.warning("federate: %s unreachable: %s", target, error)
        self._registry = result.registry
        self.exporter.set_registry(result.registry)
        return result

    def start(self) -> "FleetFederator":
        self.exporter.start()
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-federator", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape()
            except FederationError as exc:
                # a config mismatch must be visible, not fatal to the loop
                logger.warning("federate: scrape failed: %s", exc)
            self._stop.wait(self.interval_s)

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.interval_s + self.timeout_s + 5.0)
        self.exporter.close()

    def __enter__(self) -> "FleetFederator":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m replay_tpu_torch.obs.federate",
        description="Scrape N /snapshot exporters into one federated /metrics.",
    )
    parser.add_argument("targets", nargs="+", help="member base URLs (http://host:port)")
    parser.add_argument("--port", type=int, default=9200)
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument(
        "--once", action="store_true",
        help="single scrape: print the merged Prometheus text and exit "
        "(nonzero when no member answered)",
    )
    args = parser.parse_args(argv)

    federator = FleetFederator(args.targets, port=args.port, interval_s=args.interval)
    if args.once:
        scrape = federator.scrape()
        print(scrape.registry.render_prometheus(), end="")
        federator.close()
        return 0 if scrape.reachable else 1
    with federator:
        print(f"federating {len(args.targets)} members on {federator.exporter.url}")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
