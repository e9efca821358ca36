"""ObservabilityCallback: the train loop's wiring into the registry.

Port of ``veomni_tpu/observability/callback.py`` (``:39``). Placed right
after ``EnvironMeterCallback`` so the published payload already contains
the meter's throughput/MFU rollup, and before ``LoggingCallback`` so its
export-hook consumption sees this step's publish.

Per sync step (the loop's existing host<->device sync cadence — zero added
syncs): closes the goodput window and the cost census's MFU window
(``train.mfu_pct``, ``train.bandwidth_util_pct``, ...), refreshes the
memory gauges, heartbeats and exchanges the fleet's step-time skew,
publishes ``train.*`` gauges, and fires ``registry.export`` (JSONL sink +
hooks). ``train.observability_port`` (or ``VEOMNI_METRICS_PORT``) starts
the Prometheus exporter, its ``/healthz`` wired to the resilience
supervisor and ``/debug/fleet`` to the fleet monitor; it stops at train end
and on a crash (``close``). The reference's recompile detector counts XLA
retraces; eager torch has none to count, so it has no twin.
"""

from __future__ import annotations

import os
import time

from veomni_tpu_torch.observability.cost import CostWindow
from veomni_tpu_torch.observability.exporter import MetricsExporter, resolve_port
from veomni_tpu_torch.observability.goodput import GoodputTracker, update_memory_gauges
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.observability.spans import dump_chrome_trace, enable_spans
from veomni_tpu_torch.trainer.callbacks import Callback
from veomni_tpu_torch.utils.helper import host_floats
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ObservabilityCallback(Callback):
    def __init__(self):
        self.registry = None
        self.tracker = None
        self.exporter = None
        self.cost_window = None
        self.fleet = None
        self._chrome_trace_path = ""
        # per-sync-window host step timing (feeds the fleet skew exchange):
        # one perf_counter read per step, no device syncs
        self._win_t0 = 0.0
        self._win_last = 0.0
        self._win_steps = 0
        self._win_max_step_s = 0.0
        self._fleet_warm = False

    def on_train_begin(self, trainer, state):
        t = trainer.args.train
        self.registry = get_registry()
        if t.observability_spans:
            enable_spans()
        # (the flight recorder's ring size + dump dir are wired in train()'s
        # prologue, BEFORE any callback can raise — not here)
        if t.observability_jsonl:
            path = os.path.join(
                t.output_dir, f"metrics_rank{self.registry.rank()}.jsonl"
            )
            self.registry.attach_jsonl(path)
        self._chrome_trace_path = t.observability_chrome_trace
        self.tracker = GoodputTracker(self.registry)
        # fleet tier: heartbeats always (a wedged rank must be diagnosable
        # from outside), the skew exchange only with a process group of >= 2;
        # train.observability_fleet=0 turns it all off
        if t.observability_fleet:
            from veomni_tpu_torch.observability.fleet import FleetMonitor

            self.fleet = FleetMonitor(
                registry=self.registry,
                straggler_factor=t.observability_straggler_factor,
                heartbeat_dir=t.output_dir,
            )
        port = resolve_port(t.observability_port)
        if port is not None:
            sup = getattr(trainer, "_supervisor", None)
            self.exporter = MetricsExporter(
                port=port, registry=self.registry,
                health_fn=sup.health if sup is not None else None,
                fleet_fn=self.fleet.debug_doc if self.fleet else None,
            )
            self.exporter.start()
        self.tracker.begin_window()
        # the cost census's window: census FLOPs/bytes x calls over the same
        # sync cadence -> train.mfu_pct / train.bandwidth_util_pct
        self.cost_window = CostWindow()
        self.cost_window.begin()
        self._win_t0 = self._win_last = time.perf_counter()
        self._win_steps = 0
        self._win_max_step_s = 0.0
        self._fleet_warm = False  # window 1 holds the first-call census: no exchange

    def on_step_end(self, trainer, state):
        now = time.perf_counter()
        self._win_steps += 1
        self._win_max_step_s = max(self._win_max_step_s, now - self._win_last)
        self._win_last = now
        if not state.synced:
            return
        state.metrics.update(self.tracker.end_window())
        state.metrics.update(self.cost_window.end())
        update_memory_gauges(self.registry)
        if self.fleet is not None and self._win_steps:
            # heartbeat + skew exchange on the loop's sync cadence; the first
            # window heartbeats but skips the exchange (its step 1 carries the
            # census's counting pass and the kernels' build, not a straggler)
            self.fleet.observe_window(
                state.global_step,
                (now - self._win_t0) / self._win_steps,
                max_step_s=self._win_max_step_s,
                steps=self._win_steps,
                exchange=self._fleet_warm,
            )
            self._fleet_warm = True
        self._win_t0 = self._win_last = time.perf_counter()
        self._win_steps = 0
        self._win_max_step_s = 0.0
        payload = host_floats(state.metrics)
        self.registry.set_gauges("train", payload)
        self.registry.export(state.global_step, payload)

    def on_train_end(self, trainer, state):
        if self.registry is None:  # train() without on_train_begin (tests)
            return
        if self.tracker is not None:
            state.metrics.update(self.tracker.end_window())
        if self.cost_window is not None:
            state.metrics.update(self.cost_window.end())
        payload = host_floats(state.metrics)
        self.registry.set_gauges("train", payload)
        self.registry.export(state.global_step, payload)
        if self._chrome_trace_path:
            n = dump_chrome_trace(self._chrome_trace_path)
            logger.info_rank0(
                "wrote %d host span events to %s", n, self._chrome_trace_path
            )
        self.close()

    def close(self):
        """Exception-safe teardown (BaseTrainer calls every callback's
        ``close`` in its finally block): the exporter thread must not
        outlive a crashed run."""
        if self.exporter is not None:
            self.exporter.stop()
            self.exporter = None
        if self.fleet is not None:
            from veomni_tpu_torch.observability.fleet import (
                get_active_monitor,
                set_active_monitor,
            )

            # only un-register our own monitor
            if get_active_monitor() is self.fleet:
                set_active_monitor(None)
            self.fleet = None
