"""Observability of the control plane (counterpart of
``nbdistributed_tpu/observability``): span tracing (:mod:`.spans`), the
metrics registry (:mod:`.metrics`), clock-offset estimation
(:mod:`.clock`), the crash-surviving flight recorder (:mod:`.flightrec`),
the latency observatory (:mod:`.latency`), per-worker device
telemetry (:mod:`.telemetry`), the Chrome-trace merge (:mod:`.export`),
crash postmortem bundles (:mod:`.postmortem`) and the live scrape
endpoint (:mod:`.httpd`: ``/metrics``, ``/healthz``, ``/latency.json``
under ``NBD_METRICS_PORT``).  Stdlib-only at import time."""
