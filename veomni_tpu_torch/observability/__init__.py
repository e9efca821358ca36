"""Observability of the train loop (port of ``veomni_tpu/observability``).

Ported so far, the part the trainer runs on:

* ``metrics``  — the process-wide :class:`MetricsRegistry` with its
                 rank-local JSONL sink and export hooks (a copy);
* ``spans``    — host-side span tracing feeding the duration histograms,
                 mirrored into ``torch.profiler.record_function`` while a
                 profiler trace runs;
* ``goodput``  — the per-window wall-time decomposition and the ``mem.*``
                 gauges;
* ``flight_recorder`` — the bounded ring of structured events dumped to
                 ``postmortem-<rank>.json`` (a copy);
* ``callback.ObservabilityCallback`` — the loop's wiring into them.

Not ported yet: the exporter, the fleet monitor, the cost and comm censuses,
``devmem``, ``numerics`` and ``request_trace``. The trainer's feature gate
(``trainer/base.py::check_supported``) raises for the knobs that need them.
"""
