"""Observability: per-batch tracing, streaming histograms, flight-recorder
forensics, Perfetto-loadable trace export, the per-op calibration table
and the live telemetry plane (windowed metrics, Prometheus exposition,
SLO burn rates, regression watchdog): the PyTorch package's counterpart
of ``repro.obs``.

Tracing answers "what happened to that batch"; telemetry answers "what
has been happening lately". Enable with
``ServingConfig(trace=TraceConfig())`` and/or
``ServingConfig(telemetry=TelemetryConfig())``; both are off by default
and zero-cost when off (every instrumentation site is one ``is None``
test), and instrumented runs are bitwise equal to bare ones.

On a card a traced batch's device time is cut by CUDA events into
``gpu.input``, ``gpu.layer`` (arg ``l``), ``gpu.attention`` (GAT's
attention steps), ``gpu.aggregate`` (each sg Aggregate, the
scatter-gather launch) and ``gpu.tail`` spans (``Tracer.gpu_marker``).
Counted always, outside this package: the edges of each sg batch's layout
and the slots it took (``SchedulerStats.edges_shipped`` /
``edge_slots_shipped``), the subgraphs refused over their edge budget and
their edges (``core.subgraph.subgraphs_refused`` / ``edges_refused``: no
edge is ever cut) and the scatter-gather's launches by (variant, C, N, E,
F) (``kernels.scatter_gather.shape_launches``).
"""
from repro_torch.obs.calib import CalibrationTable, run_instrumented
from repro_torch.obs.events import EventRing
from repro_torch.obs.export import (containment, to_chrome_trace,
                                    validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.hist import (LogHistogram, Reservoir, hist_dict_quantile,
                                  merge_hist_dicts)
from repro_torch.obs.metrics import (MetricsRegistry, Telemetry,
                                     TelemetryConfig, WindowedHistogram,
                                     inject_labels, merge_wire, series_count)
from repro_torch.obs.promexp import (MetricsHTTPServer, render_wire,
                                     validate_exposition)
from repro_torch.obs.slo import SLObjective, SLOTracker, Watchdog
from repro_torch.obs.trace import (SpanAllocator, TraceConfig, TraceContext,
                                   Tracer, from_perf_counter, now,
                                   perf_counter_of, span_dict)

__all__ = [
    "TraceConfig", "TraceContext", "Tracer", "SpanAllocator",
    "span_dict", "now", "perf_counter_of", "from_perf_counter",
    "LogHistogram", "Reservoir", "hist_dict_quantile",
    "merge_hist_dicts",
    "FlightRecorder",
    "CalibrationTable", "run_instrumented",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "containment",
    "TelemetryConfig", "MetricsRegistry", "Telemetry",
    "WindowedHistogram", "merge_wire", "inject_labels", "series_count",
    "render_wire", "validate_exposition", "MetricsHTTPServer",
    "SLObjective", "SLOTracker", "Watchdog",
    "EventRing",
]
