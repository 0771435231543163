"""Observability: per-batch tracing, streaming histograms, flight-recorder
forensics, Perfetto-loadable trace export and the per-op calibration table
(the PyTorch package's counterpart of ``repro.obs``; its telemetry plane,
ROADMAP queue 1 item 12, is not ported).

Enable tracing with ``ServingConfig(trace=TraceConfig())``: off by default
and zero-cost when off (every instrumentation site is one ``is None``
test), and traced runs are bitwise equal to untraced ones.
"""
from repro_torch.obs.calib import CalibrationTable, run_instrumented
from repro_torch.obs.export import (containment, to_chrome_trace,
                                    validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.hist import (LogHistogram, Reservoir, hist_dict_quantile,
                                  merge_hist_dicts)
from repro_torch.obs.trace import (SpanAllocator, TraceConfig, TraceContext,
                                   Tracer, now, span_dict)

__all__ = [
    "TraceConfig", "TraceContext", "Tracer", "SpanAllocator",
    "span_dict", "now",
    "LogHistogram", "Reservoir", "hist_dict_quantile",
    "merge_hist_dicts",
    "FlightRecorder",
    "CalibrationTable", "run_instrumented",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "containment",
]
