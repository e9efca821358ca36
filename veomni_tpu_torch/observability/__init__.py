"""Observability of the train loop and the server (port of
``veomni_tpu/observability``):

* ``metrics``  — the process-wide :class:`MetricsRegistry` with its
                 rank-local JSONL sink and export hooks (a copy);
* ``spans``    — host-side span tracing feeding the duration histograms,
                 mirrored into ``torch.profiler.record_function`` while a
                 profiler trace runs;
* ``goodput``  — the per-window wall-time decomposition and the ``mem.*``
                 gauges;
* ``flight_recorder`` — the bounded ring of structured events dumped to
                 ``postmortem-<rank>.json`` (a copy);
* ``request_trace`` — per-request lifecycle timelines of the serving engine;
* ``numerics`` — the training-health observatory: per-group grad/param
                 RMS, absmax, non-finite counts, update ratio and overflow
                 margin from the instrumented step, and the non-finite
                 provenance of an anomalous step;
* ``cost``     — the program cost census: FLOPs and bytes of each
                 instrumented site's first call per bucket (a dispatch-mode
                 count plus the hand kernels' own reports; the serving
                 sites once a process for a model, and only while the
                 exporter runs) and the window MFU / bandwidth utilization;
* ``devmem``   — device-memory accounting: the storage census, watermarks,
                 the OOM post-mortem payload;
* ``exporter`` — the stdlib HTTP exporter: ``/metrics``, ``/healthz`` and
                 the ``/debug/*`` routes;
* ``fleet``    — heartbeats, the step-time skew exchange and ``/debug/fleet``;
* ``callback.ObservabilityCallback`` — the trainer's wiring into them.

Not ported: ``comm`` (a census of the collectives in a compiled program):
the port runs at world size 1 until slice C, so there is no collective to
count.
"""
