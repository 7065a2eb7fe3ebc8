"""The live metrics plane, the flight ring and tracing of the port
(``replay_tpu_torch/obs/{metrics,exporter,slo,blackbox,trace}.py`` and
``Trainer.fit``'s arguments) against the JAX package's, on the CPU.

* One scripted event stream (training, health, anomalies, goodput, serving)
  through both packages' ``MetricsLogger``: byte-identical
  ``render_prometheus`` text and equal ``/snapshot`` documents (each served by
  its own exporter on an ephemeral localhost port; the identity block, pid
  and start time, left out).
* The same stream through both ``SLOWatchdog``s on one injected clock: the
  same violation and recovery events.
* A ring written by the port reads back with the JAX ``read_flight`` and the
  other way round; a port-only worker killed by ``SIGKILL`` mid-recording
  leaves a ring both read in full.
* A CPU ``fit(tracer=True)`` writes a valid Chrome trace whose goodput keys
  and span names are the JAX fit's on the same batches; ``fit(metrics_port=0,
  slo_rules=..., flight_path=...)`` serves a scrape mid-fit and closes the
  exporter and the ring at the end.
"""

import json
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.obs import blackbox as jax_blackbox
from replay_tpu.obs import events as jax_events
from replay_tpu.obs import exporter as jax_exporter
from replay_tpu.obs import metrics as jax_metrics
from replay_tpu.obs import slo as jax_slo
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.obs import blackbox, events, exporter, metrics, slo

WORKER = Path(__file__).with_name("flight_kill_worker_torch.py")
NUM_ITEMS, DIM, SEQ_LEN, BATCH = 40, 16, 8, 4
WIDTH = dict(embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN)


def script():
    """(event, step, epoch, payload) of a short fit and a few serve batches."""
    stream = [("on_fit_start", 0, 0, {"epochs": 1})]
    for step in range(1, 9):
        payload = {
            "loss": 4.0 - step * 0.1, "lr": 1e-3, "samples_per_sec": 100.0 + step, "steps_per_sec": 25.0,
            "step_seconds": 0.004 * step, "effective_tokens_per_sec": 800.0, "padding_fraction": 0.25,
        }
        if step % 4 == 0:
            payload["health"] = {"grad_norm_global": 0.5 * step, "update_ratio": {"block_0": 0.01 * step, "head": 0.02}}
        stream.append(("on_train_step", step, 0, payload))
        if step == 5:
            stream.append(("on_anomaly", step, 0, {"bad_steps_total": 1, "consecutive_bad": 1}))
            stream.append(("on_health_warning", step, 0, {"signal": "grad_norm", "value": 9.0, "factor": 6.0, "ewma": 1.5}))
    goodput = {"wall_seconds": 2.0, "fractions": {"train_step": 0.7, "data_wait": 0.1, "other": 0.2}, "input_starvation": 0.12}
    stream += [
        ("on_epoch_end", 8, 0, {"record": {"train_loss": 3.5}, "bad_steps": 1, "goodput": goodput,
                                "input": {"effective_tokens_per_sec": 790.0, "padding_fraction": 0.25}}),
        ("on_serve_batch", None, None, {"rows": 6, "fill": 0.75, "queue_wait_ms_max": 1.5, "bucket": 8, "lane": "score"}),
        ("on_shed", None, None, {"count": 2, "lane": "score", "depth": 9, "max_depth": 8}),
        ("on_fit_end", 8, 0, {"bad_steps": 1, "goodput": goodput, "telemetry": {"samples_per_sec": 104.0}}),
    ]
    return stream


def feed(module, event_module, logger):
    for name, step, epoch, payload in script():
        logger.log_event(event_module.TrainerEvent(event=name, step=step, epoch=epoch, payload=payload))


def snapshot_over_http(exporter_module, registry):
    served = exporter_module.MetricsExporter(registry, port=0).start()
    try:
        document = json.loads(urllib.request.urlopen(f"{served.url}/snapshot", timeout=5).read().decode())
        text = urllib.request.urlopen(f"{served.url}/metrics", timeout=5).read().decode()
    finally:
        served.close()
    document.pop("__identity__")
    return document, text


def test_metrics_render_and_snapshot_equal_jax():
    loggers = []
    for module, event_module in ((metrics, events), (jax_metrics, jax_events)):
        logger = module.MetricsLogger(clock=lambda: 100.0)
        feed(module, event_module, logger)
        loggers.append(logger)
    port_text, jax_text = (m.render_prometheus(lg.registry) for m, lg in zip((metrics, jax_metrics), loggers))
    assert port_text == jax_text
    assert "replay_train_loss " in port_text and "replay_health_warnings_total" in port_text
    port_doc, port_served = snapshot_over_http(exporter, loggers[0].registry)
    jax_doc, jax_served = snapshot_over_http(jax_exporter, loggers[1].registry)
    assert port_doc == jax_doc and port_served == jax_served == port_text


def test_slo_watchdogs_give_the_jax_events():
    seen = []
    for module, metrics_module, event_module in ((slo, metrics, events), (jax_slo, jax_metrics, jax_events)):
        times = iter(float(t) for t in range(1000))
        clock = lambda: next(times)  # noqa: E731
        out = []
        rules = [
            module.SLORule(metric="replay_train_loss", op=">", threshold=3.45, for_steps=2, name="loss"),
            module.SLORule(metric="replay_train_bad_steps", op=">", threshold=0),
            module.SLORule(metric="replay_train_step_seconds:p99", op=">", threshold=0.02),
        ]
        logger = metrics_module.MetricsLogger(clock=lambda: 0.0)
        logger.watchdog = module.SLOWatchdog(rules, logger.registry, emit=out.append, clock=clock)
        feed(metrics_module, event_module, logger)
        seen.append([(e.event, e.step, e.payload) for e in out])
    assert seen[0] == seen[1]
    assert [name for name, _, _ in seen[0]].count("on_slo_violation") >= 2
    assert "on_slo_recovery" in [name for name, _, _ in seen[0]]


def test_flight_rings_read_across_packages(tmp_path):
    for writer, reader in ((blackbox, jax_blackbox), (jax_blackbox, blackbox)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.ring")
        log = writer.BlackboxLogger(path, meta={"role": "fit"})
        feed(None, events if writer is blackbox else jax_events, log)
        log.close()
        got, want = reader.read_flight(path), writer.read_flight(path)
        # the ring opens with the logger's meta record
        assert got.records == want.records and len(got.records) == len(script()) + 1
        assert got.records[0]["event"] == "flight_open" and got.records[0]["role"] == "fit"
        assert (got.capacity, got.record_size, got.torn_tail) == (want.capacity, want.record_size, False)
        assert got.records[-1]["event"] == "on_fit_end"


def test_a_sigkilled_port_worker_leaves_a_readable_ring(tmp_path):
    ring = str(tmp_path / "killed.ring")
    proc = subprocess.run([sys.executable, str(WORKER), ring, "25"], capture_output=True, text=True, timeout=60)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-500:]
    for module in (blackbox, jax_blackbox):
        log = module.read_flight(ring)
        assert (log.recovered, log.last_seqno, log.torn_tail) == (25, 25, False)
        assert [r["step"] for r in log.records] == list(range(25))


def train_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - rng.integers(2, SEQ_LEN + 1, BATCH)[:, None]
    items = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN + 1)).astype(np.int32)
    return {
        "feature_tensors": {"item_id": np.where(mask, items[:, :-1], NUM_ITEMS).astype(np.int32)},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


BATCHES = [train_batch(seed) for seed in range(6)]


class Sink:
    def __init__(self, on_step=None):
        self.events, self.on_step = [], on_step

    def log_event(self, event):
        self.events.append(event)
        if event.event == "on_train_step" and self.on_step is not None:
            self.on_step(event)


def port_trainer():
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    model = SasRec(schema, device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH)
    return Trainer(model, CE(), device="cpu")


def test_traced_fit_writes_a_chrome_trace_with_the_jax_goodput_keys(tmp_path):
    port = port_trainer()
    initial = {name: value.detach().clone() for name, value in port.model.state_dict().items()}
    port_sink = Sink()
    port.fit(BATCHES, epochs=2, log_every=0, loggers=[port_sink], tracer=True, trace_path=str(tmp_path / "port.json"))
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    jax_side = JaxTrainer(model=JaxSasRec(schema=schema, **WIDTH), loss=JaxCE())
    jax_sink = Sink()
    jax_side.fit(
        BATCHES, epochs=2, log_every=0, loggers=[jax_sink], tracer=True, trace_path=str(tmp_path / "jax.json"),
        state=jax_side.init_state(BATCHES[0], params=torch_to_flax(initial)),
    )

    def goodput_layout(sink):
        return [
            (e.event, sorted(e.payload["goodput"]), sorted(e.payload["goodput"]["fractions"]))
            for e in sink.events if "goodput" in e.payload
        ]

    assert goodput_layout(port_sink) == goodput_layout(jax_sink) and len(goodput_layout(port_sink)) == 3
    port_end, jax_end = (s.events[-1].payload for s in (port_sink, jax_sink))
    assert set(port_end["spans"]) == set(jax_end["spans"])
    assert port_end["spans"]["train_step"]["count"] == jax_end["spans"]["train_step"]["count"] == 12
    for e in port_sink.events:
        if "goodput" in e.payload:
            assert sum(e.payload["goodput"]["fractions"].values()) == pytest.approx(1.0, abs=1e-9)
    chrome = json.loads((tmp_path / "port.json").read_text())
    assert isinstance(chrome["traceEvents"], list) and chrome["traceEvents"]
    complete = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    assert {"train_step", "data_wait", "h2d", "compile"} <= {e["name"] for e in complete}
    assert all(isinstance(e["ts"], (int, float)) and e["dur"] >= 0 and "pid" in e and "tid" in e for e in complete)
    assert port.tracer is None  # a tracer given to fit scopes to that fit


def test_fit_serves_metrics_mid_fit_fires_slo_rules_and_records_the_ring(tmp_path):
    trainer = port_trainer()
    scraped = []

    def scrape(event):
        if event.step == 3:
            url = trainer.metrics_exporter.url
            scraped.append(urllib.request.urlopen(f"{url}/metrics", timeout=5).read().decode())
            scraped.append(urllib.request.urlopen(f"{url}/healthz", timeout=5).read().decode())

    sink = Sink(on_step=scrape)
    rule = slo.SLORule(metric="replay_train_step", op=">=", threshold=4, name="planted")
    ring = str(tmp_path / "fit.ring")
    trainer.fit(BATCHES, log_every=0, loggers=[sink], metrics_port=0, slo_rules=[rule], flight_path=ring)
    assert "replay_train_loss " in scraped[0] and scraped[1].strip() == "ok"
    violations = [e for e in sink.events if e.event == "on_slo_violation"]
    assert len(violations) == 1 and violations[0].payload["rule"] == "planted" and violations[0].step == 4
    assert trainer.metrics_exporter is None and trainer.metrics_registry.value("replay_train_steps_total") == 6
    log = blackbox.read_flight(ring)
    assert [r["event"] for r in log.records][-1] == "on_fit_end" and not log.torn_tail
    assert log.records[0]["event"] == "flight_open" and log.records[0]["role"] == "fit"
