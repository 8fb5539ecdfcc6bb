"""Observability (twin of ``repro/obs``): pipeline tracing, drift
reports, metrics registry.

  * :mod:`repro_torch.obs.trace`    — :class:`PipelineTracer`: per-event
    spans from the IR interpreter (CUDA events on a card, the host clock
    on the CPU), per-rank tick spans under stage-local execution,
    per-step wall time for the streaming runtime, and a parallel-
    timeline reconstruction.
  * :mod:`repro_torch.obs.perfetto` — Chrome/Perfetto trace-JSON export
    (measured + predicted lane groups) and a trace-schema validator.
  * :mod:`repro_torch.obs.drift`    — predicted-vs-measured drift
    report: realized bubble, per-stage busy/idle shares, staleness
    histograms, per-stage cost-model relative error.
  * :mod:`repro_torch.obs.metrics`  — counters / gauges / histograms +
    structured events → JSONL and a summary table.
"""
from repro_torch.obs.drift import drift_report, format_drift  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, format_step,
)
from repro_torch.obs.perfetto import (trace_events,  # noqa: F401
                                      validate_trace, write_trace)
from repro_torch.obs.trace import (PipelineTracer, Span,  # noqa: F401
                                   device_stream_tick_groups,
                                   probe_stage_costs, round_event_metas)
