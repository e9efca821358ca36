"""The port's Prometheus exporter (``veomni_tpu_torch/observability/exporter.py``)
against the JAX one, on the CPU.

* ``render_prometheus``: the same counters, gauges and histograms (a
  native-bucket SLO family among them, seeded values) in the port's and
  the reference's registries render to the same text, byte for byte.
* Every route answers on an ephemeral port: ``/metrics``, ``/healthz``
  (200, and 503 when the health document says unhealthy), ``/debug/flight``
  (``?n=``), ``/debug/requests``, ``/debug/memory`` (with a pool document),
  ``/debug/cost``, ``/debug/numerics`` (the disabled stub naming its knob),
  ``/debug/fleet`` and ``/debug/router``; an unknown route is a 404.
* ``resolve_port``: ``VEOMNI_METRICS_PORT`` overrides the knob, a negative
  value is an ephemeral bind, 0 is off; ``maybe_start_from_env`` as the
  reference's.
* The trainer with ``observability_port: -1`` serves ``/healthz`` from the
  supervisor and ``/debug/fleet`` from its fleet monitor while it trains,
  and stops the exporter at train end.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np

from veomni_tpu.observability.exporter import render_prometheus as j_render
from veomni_tpu.observability.metrics import MetricsRegistry as JRegistry
from veomni_tpu_torch.observability.exporter import (
    MetricsExporter,
    maybe_start_from_env,
    render_prometheus,
    resolve_port,
)
from veomni_tpu_torch.observability.metrics import MetricsRegistry

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _fill(reg):
    rng = np.random.default_rng(3)
    reg.counter("serve.rejected").inc(3)
    reg.counter("cost.programs").inc()
    reg.gauge("train.loss").set(2.5)
    reg.gauge("numerics.layers.q_proj.grad_rms").set(1.25e-3)
    for v in rng.exponential(0.05, 40):
        reg.histogram("serve.ttft_s").observe(float(v))  # a native-bucket family
    for v in rng.exponential(0.3, 25):
        reg.histogram("span.data.wait").observe(float(v))


def test_render_prometheus_equals_the_reference():
    j_reg, reg = JRegistry(), MetricsRegistry()
    _fill(j_reg)
    _fill(reg)
    got, want = render_prometheus(reg), j_render(j_reg)
    assert "veomni_serve_ttft_s_hist_bucket" in got
    assert got == want


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_every_route_answers_on_an_ephemeral_port():
    reg = MetricsRegistry()
    _fill(reg)
    healthy = [True]
    exp = MetricsExporter(
        port=0, host="127.0.0.1", registry=reg,
        health_fn=lambda: {"healthy": healthy[0], "rollbacks": 0},
        requests_fn=lambda: {"inflight": [{"request_id": "r1"}], "finished": []},
        memory_fn=lambda: {"pool_bytes": 1024.0},
        fleet_fn=lambda: {"enabled": True, "rank": 0},
        router_fn=lambda: {"replicas": [{"rid": "r0"}], "retired": []})
    port = exp.start()
    try:
        status, body = _get(port, "/metrics")
        assert status == 200 and b'veomni_serve_rejected{rank="0"} 3.0' in body
        assert _get(port, "/healthz") == (200, json.dumps({"healthy": True,
                                                            "rollbacks": 0}).encode())
        healthy[0] = False
        assert _get(port, "/healthz")[0] == 503
        docs = {}
        for route in ("/debug/flight?n=5", "/debug/requests", "/debug/memory?k=3",
                      "/debug/cost", "/debug/numerics", "/debug/fleet", "/debug/router"):
            status, body = _get(port, route)
            assert status == 200, route
            docs[route.split("?")[0]] = json.loads(body)
        assert docs["/debug/requests"]["inflight"][0]["request_id"] == "r1"
        assert docs["/debug/memory"]["pool"] == {"pool_bytes": 1024.0}
        assert len(docs["/debug/memory"]["buffer_census"]["top"]) <= 3
        assert "programs" in docs["/debug/cost"] and "live" in docs["/debug/cost"]
        assert docs["/debug/numerics"]["enabled"] is False
        assert "observability_numerics_interval" in docs["/debug/numerics"]["hint"]
        assert docs["/debug/fleet"] == {"enabled": True, "rank": 0}
        assert docs["/debug/router"]["replicas"][0]["rid"] == "r0"
        assert _get(port, "/nope")[0] == 404
    finally:
        exp.stop()
    assert not any(t.name == "veomni-metrics-http" for t in threading.enumerate())


def test_resolve_port_and_env_start(monkeypatch):
    from veomni_tpu.observability.exporter import resolve_port as j_resolve

    for env, knob in (("", 0), ("", 9100), ("", -1), ("-1", 9100), ("9200", 0), ("0", 9100)):
        monkeypatch.setenv("VEOMNI_METRICS_PORT", env)
        assert resolve_port(knob) == j_resolve(knob), (env, knob)
    monkeypatch.setenv("VEOMNI_METRICS_PORT", "")
    assert maybe_start_from_env(config_port=0) is None
    monkeypatch.setenv("VEOMNI_METRICS_PORT", "-1")
    exp = maybe_start_from_env(health_fn=lambda: {"healthy": True})
    try:
        assert exp is not None and exp.port > 0 and _get(exp.port, "/healthz")[0] == 200
    finally:
        exp.stop()


def test_trainer_serves_health_and_fleet_while_training(tmp_path):
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    from test_e2e_training import _write_dummy_data
    from test_torch_trainer import port_args

    seen = {}

    class Scrape(Callback):
        def on_step_end(self, trainer, state):
            if state.global_step == 2:
                exp = next(cb.exporter for cb in trainer.callbacks if hasattr(cb, "exporter"))
                for route in ("/healthz", "/debug/fleet", "/metrics"):
                    seen[route] = _get(exp.port, route)

    _write_dummy_data(tmp_path / "data.jsonl")
    trainer = TextTrainer(port_args(tmp_path, train_steps=3, log_steps=1,
                                    observability_port=-1))
    trainer.callbacks.append(Scrape())
    trainer.train()
    trainer.checkpointer.close()
    destroy_parallel_state()
    status, body = seen["/healthz"]
    assert status == 200 and json.loads(body)["healthy"] is True
    fleet = json.loads(seen["/debug/fleet"][1])
    assert fleet["enabled"] and fleet["world_size"] == 1 and not fleet["exchange_enabled"]
    assert fleet["heartbeats"][0]["global_step"] == 2
    assert b"veomni_train_loss" in seen["/metrics"][1]
    assert not any(t.name == "veomni-metrics-http" for t in threading.enumerate())
