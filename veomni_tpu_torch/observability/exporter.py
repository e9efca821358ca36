"""Stdlib-only Prometheus exporter + health and debug endpoints.

Port of ``veomni_tpu/observability/exporter.py`` (the port's own census,
numerics and fleet modules behind the same routes). One daemon thread,
zero dependencies: ``/metrics`` renders the registry in Prometheus text
exposition format 0.0.4; ``/healthz`` serves a JSON health
document (the trainer wires it to the resilience supervisor's state — a
scraper or k8s probe sees rollbacks/aborts without log scraping);
``/debug/flight`` returns the flight recorder's recent events (``?n=``
bounds the tail); ``/debug/requests`` the serving engine's in-flight
request timelines (``requests_fn``); ``/debug/memory`` the live buffer
census + device-memory watermark (plus the KV pool capacity document when
``memory_fn`` is wired — ``tasks/serve.py`` passes the engine's
``kv_capacity``); ``/debug/cost`` the program cost census
with a scrape-to-scrape live MFU window (a running exporter is the
census's reader: while one runs, the serving engine's sites count their
new buckets too, ``observability/cost.py``); ``/debug/numerics`` the
numerics observatory's latest per-group training-health summary,
history ring and non-finite provenance (the process's active
``NumericsMonitor``; a disabled stub names the knob); and
``/debug/fleet`` the
cross-rank view (per-rank step-time skew table, heartbeat freshness,
collective census — ``fleet_fn`` or the process's active
``FleetMonitor``); and ``/debug/router`` the scale-out router's replica
census (per-replica state/queue/assignment, retired replicas, weights
version — ``router_fn``, wired by ``tasks/serve.py --replicas N``; an
unwired deployment reports an empty document). Usable by both the trainer
(``train.observability_port`` / ``VEOMNI_METRICS_PORT``) and
``serving.InferenceEngine`` (``tasks/serve.py``).
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from veomni_tpu_torch.observability.cost import close_reader, open_reader
from veomni_tpu_torch.observability.metrics import (
    SLO_BUCKET_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "veomni_" + _NAME_RE.sub("_", name)


#: families additionally rendered as NATIVE Prometheus histograms
#: (`<name>_hist_bucket{le=...}`): the serving latency SLOs need
#: `histogram_quantile(0.99, rate(..._hist_bucket[5m]))` to work in
#: PromQL — the summary's fixed p50/p95 quantiles can't answer a p99
#: query. Covers TTFT, TPOT and queue wait (the third serving-SLO family:
#: queue wait is the signal the QoS layer's shedding/deadline decisions
#: act on). Rendered under a `_hist` sibling name because one metric name
#: cannot be both TYPE summary and TYPE histogram. The bounds table lives
#: in metrics.py (SLO_BUCKET_BOUNDS) so the registry attaches EXACT
#: per-bucket counters at observe() time — rate() over these series needs
#: monotone counters, which a reservoir estimate cannot promise across
#: scrapes. The bounds themselves (LATENCY_BUCKETS) live in metrics.py.
NATIVE_HISTOGRAM_FAMILIES = SLO_BUCKET_BOUNDS


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Registry -> Prometheus text format. Counters/gauges map directly;
    histograms render as summaries (quantile labels + _sum/_count) plus a
    ``_max`` gauge (p100 is the stall-hunting number quantiles smear); the
    families in :data:`NATIVE_HISTOGRAM_FAMILIES` additionally render as
    native cumulative-bucket histograms for PromQL quantile queries."""
    reg = registry or get_registry()
    rank = str(reg.rank())
    lines = []
    for name, m in reg.items_snapshot():
        pname = _prom_name(name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f'{pname}{{rank="{rank}"}} {m.value}')
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f'{pname}{{rank="{rank}"}} {m.value}')
        elif isinstance(m, Histogram):
            snap = m.snapshot()
            lines.append(f"# TYPE {pname} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95")):
                if key in snap:
                    lines.append(
                        f'{pname}{{rank="{rank}",quantile="{q}"}} {snap[key]}'
                    )
            lines.append(f'{pname}_sum{{rank="{rank}"}} {snap["sum"]}')
            lines.append(f'{pname}_count{{rank="{rank}"}} {int(snap["count"])}')
            if "max" in snap:
                lines.append(f"# TYPE {pname}_max gauge")
                lines.append(f'{pname}_max{{rank="{rank}"}} {snap["max"]}')
            bounds = NATIVE_HISTOGRAM_FAMILIES.get(name)
            if bounds is not None:
                hname = f"{pname}_hist"
                lines.append(f"# TYPE {hname} histogram")
                for le, count in m.cumulative_buckets(bounds):
                    le_txt = le if le == "+Inf" else repr(float(le))
                    lines.append(
                        f'{hname}_bucket{{rank="{rank}",le="{le_txt}"}} '
                        f"{count}"
                    )
                lines.append(f'{hname}_sum{{rank="{rank}"}} {snap["sum"]}')
                lines.append(
                    f'{hname}_count{{rank="{rank}"}} {int(snap["count"])}'
                )
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Daemon-thread HTTP server for ``/metrics`` and ``/healthz``.

    ``port=0`` binds an ephemeral port (tests); :meth:`start` returns the
    actual port. ``health_fn`` returns a JSON-serializable dict; a falsy
    ``"healthy"`` key turns the response into a 503 so load balancers and
    probes need no body parsing. The 503 must be *recoverable*: callers
    wire live state, not a latched flag — the serving router's
    ``health()`` (tasks/serve.py) flips unhealthy while its live
    replica count sits under ``min_live`` and back to 200 once respawned
    replicas clear probation, so a probe watching this endpoint sees the
    self-healing cycle, not a tombstone."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 registry: Optional[MetricsRegistry] = None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 requests_fn: Optional[Callable[[], Dict]] = None,
                 memory_fn: Optional[Callable[[], Dict]] = None,
                 fleet_fn: Optional[Callable[[], Dict]] = None,
                 router_fn: Optional[Callable[[], Dict]] = None):
        self.requested_port = port
        self.host = host
        self.registry = registry  # None -> resolve the global lazily
        self.health_fn = health_fn
        # serving wires RequestTracer.snapshot here; the trainer leaves it
        # None and /debug/requests reports an empty document
        self.requests_fn = requests_fn
        # serving wires InferenceEngine.kv_capacity here; /debug/memory
        # serves the buffer census either way
        self.memory_fn = memory_fn
        # the trainer wires FleetMonitor.debug_doc; unwired, /debug/fleet
        # falls back to the process's active monitor (fleet.debug_fleet_doc)
        self.fleet_fn = fleet_fn
        # scale-out serving wires Router.debug_doc; unwired, /debug/router
        # reports an empty replica census (single-engine deployment)
        self.router_fn = router_fn
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        if self._server is not None:
            return self.port
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no per-scrape stderr spam
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    route, _, query = self.path.partition("?")
                    if route == "/metrics":
                        body = render_prometheus(exporter.registry).encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; charset=utf-8")
                    elif route == "/healthz":
                        doc = {"healthy": True}
                        if exporter.health_fn is not None:
                            doc = dict(exporter.health_fn())
                        code = 200 if doc.get("healthy", True) else 503
                        self._send(code, json.dumps(doc).encode(),
                                   "application/json")
                    elif route == "/debug/flight":
                        from veomni_tpu_torch.observability.flight_recorder import (
                            get_flight_recorder,
                        )

                        limit = 200
                        for part in query.split("&"):
                            if part.startswith("n="):
                                try:  # a typo'd ?n= must not read as a 500
                                    # 0 = the whole ring, same convention as
                                    # FlightRecorder.events(limit=0)
                                    limit = max(0, int(part[2:]))
                                except ValueError:
                                    pass
                        doc = get_flight_recorder().snapshot(limit)
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/requests":
                        doc = {"inflight": [], "finished": []}
                        if exporter.requests_fn is not None:
                            doc = dict(exporter.requests_fn())
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/memory":
                        from veomni_tpu_torch.observability.devmem import (
                            debug_memory_doc,
                        )

                        top_k = 10
                        for part in query.split("&"):
                            if part.startswith("k="):
                                try:  # a typo'd ?k= must not read as a 500
                                    top_k = max(0, int(part[2:]))
                                except ValueError:
                                    pass
                        doc = debug_memory_doc(exporter.memory_fn,
                                               top_k=top_k)
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/cost":
                        from veomni_tpu_torch.observability.cost import (
                            debug_cost_doc,
                        )

                        doc = debug_cost_doc()
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/numerics":
                        from veomni_tpu_torch.observability.numerics import (
                            debug_numerics_doc,
                        )

                        doc = debug_numerics_doc()
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/fleet":
                        if exporter.fleet_fn is not None:
                            doc = dict(exporter.fleet_fn())
                        else:
                            from veomni_tpu_torch.observability.fleet import (
                                debug_fleet_doc,
                            )

                            doc = debug_fleet_doc()
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    elif route == "/debug/router":
                        doc = {"replicas": [], "retired": []}
                        if exporter.router_fn is not None:
                            doc = dict(exporter.router_fn())
                        self._send(200, json.dumps(doc, default=str).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # a broken scrape must not kill us
                    try:
                        self._send(500, str(e).encode(), "text/plain")
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((self.host, self.requested_port),
                                           Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="veomni-metrics-http",
            daemon=True,
        )
        self._thread.start()
        open_reader()  # /debug/cost and the cost.* families read the census
        logger.info_rank0(
            "metrics exporter serving /metrics and /healthz on %s:%d",
            self.host, self.port,
        )
        return self.port

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
            close_reader()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def resolve_port(config_port: int = 0) -> Optional[int]:
    """Effective exporter port: ``VEOMNI_METRICS_PORT`` overrides the config
    knob. ``0``/unset disables; negative means "ephemeral" (tests)."""
    raw = os.environ.get("VEOMNI_METRICS_PORT", "").strip()
    port = int(raw) if raw else config_port
    if port == 0:
        return None
    return max(port, 0)  # negative -> 0 -> ephemeral bind


def maybe_start_from_env(registry: Optional[MetricsRegistry] = None,
                         health_fn: Optional[Callable[[], Dict]] = None,
                         config_port: int = 0,
                         requests_fn: Optional[Callable[[], Dict]] = None,
                         memory_fn: Optional[Callable[[], Dict]] = None,
                         fleet_fn: Optional[Callable[[], Dict]] = None,
                         router_fn: Optional[Callable[[], Dict]] = None,
                         ) -> Optional[MetricsExporter]:
    """Start an exporter iff configured; returns it (caller owns stop())."""
    port = resolve_port(config_port)
    if port is None:
        return None
    exp = MetricsExporter(port=port, registry=registry, health_fn=health_fn,
                          requests_fn=requests_fn, memory_fn=memory_fn,
                          fleet_fn=fleet_fn, router_fn=router_fn)
    exp.start()
    return exp
