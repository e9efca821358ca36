"""ObservabilityCallback: the train loop's wiring into the registry.

Port of ``veomni_tpu/observability/callback.py`` (``:39``), the registry,
span, JSONL and goodput parts. Placed right after ``EnvironMeterCallback``
so the published payload already contains the meter's throughput/MFU
rollup, and before ``LoggingCallback`` so its export-hook consumption sees
this step's publish.

Per sync step (the loop's existing host<->device sync cadence — zero added
syncs): closes the goodput window, refreshes the memory gauges, publishes
``train.*`` gauges, and fires ``registry.export`` (JSONL sink + hooks).

Not ported yet, each the port's slice E: the recompile detector (it counts
XLA retraces; eager torch has none to count), the compiled-program cost
window (an HLO census), the Prometheus exporter (``observability_port``
raises at the trainer's gate) and the fleet monitor. ``observability_fleet``
defaults to on in the reference; this callback says once, at train begin,
that the port runs without fleet heartbeats.
"""

from __future__ import annotations

import os

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
        self._chrome_trace_path = ""

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
        if t.observability_fleet:
            logger.warning_rank0(
                "train.observability_fleet=%d: the fleet tier (per-rank heartbeat files, "
                "step-time skew exchange) is not ported yet; this run writes no heartbeats",
                t.observability_fleet,
            )
        self._chrome_trace_path = t.observability_chrome_trace
        self.tracker = GoodputTracker(self.registry)
        self.tracker.begin_window()

    def on_step_end(self, trainer, state):
        if not state.synced:
            return
        state.metrics.update(self.tracker.end_window())
        update_memory_gauges(self.registry)
        payload = host_floats(state.metrics)
        self.registry.set_gauges("train", payload)
        self.registry.export(state.global_step, payload)

    def on_train_end(self, trainer, state):
        if self.registry is None:  # train() without on_train_begin (tests)
            return
        if self.tracker is not None:
            state.metrics.update(self.tracker.end_window())
        payload = host_floats(state.metrics)
        self.registry.set_gauges("train", payload)
        self.registry.export(state.global_step, payload)
        if self._chrome_trace_path:
            n = dump_chrome_trace(self._chrome_trace_path)
            logger.info_rank0(
                "wrote %d host span events to %s", n, self._chrome_trace_path
            )
