"""``repro_torch.obs`` — tracing and metrics for the port's ``fit()``.

The port of ``repro.obs``; every piece is off by default and near-zero
cost when off:

* ``repro_torch.obs.trace`` — per-run structured tracing: ``RunTrace``
  holds the per-round records every driver emits (round index, live
  count, realized alpha, removal threshold, stopping-rule margin, uplink
  rows, achieved wire bytes, wall/build split), plus ``Span``/``event``
  timelines in ``trace="full"`` mode. Activated by ``fit(trace=...)``;
  drivers publish through the ambient ``current_trace()``.
* ``repro_torch.obs.metrics`` — one registry over the port's counters
  (wire-tally scoping, kernel launches) behind a single
  ``read()``/``reset()``/``scope()`` API, plus owned counters, gauges,
  histograms (serving latency) and event logs (drift re-clusters).
* ``repro_torch.obs.export`` + ``repro_torch.obs.report`` — JSONL and
  Chrome trace-event exporters and the run-report CLI:
  ``python -m repro_torch.obs.report <trace.jsonl> [other.jsonl]``.
"""
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import (ROUND_SCHEMA, RunTrace, Span, clock,
                                   current_trace, emit_round, event,
                                   run_trace, set_clock, span)

__all__ = [
    "REGISTRY", "MetricsRegistry", "ROUND_SCHEMA", "RunTrace", "Span",
    "clock", "current_trace", "emit_round", "event", "run_trace",
    "set_clock", "span",
]
