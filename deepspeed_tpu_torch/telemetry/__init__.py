"""Unified telemetry subsystem (structured spans, gauges, counters,
windowed histograms with JSONL + Perfetto/Chrome-trace export), plus the
observability layer on top of it: request-scoped tracing (``tracing``),
the SLO burn-rate engine (``slo``), the anomaly flight recorder
(``flight_recorder``), Prometheus text exposition (``prometheus``),
serving roofline/goodput/host-gap capacity accounting (``capacity``), and
on-demand ``torch.profiler`` device captures (``profiler``).

Port of ``deepspeed_tpu/telemetry/`` with the same exports; the JSONL and
the Chrome trace are the JAX package's formats, so ``tools/trace_summary.py``
reads either.
"""

from .sink import TelemetrySink, get_sink, set_sink  # noqa: F401
from .tracing import RequestTrace, extract_trace_context, make_trace_id  # noqa: F401
from .slo import DEFAULT_SERVING_OBJECTIVES, SLOEngine  # noqa: F401
from .flight_recorder import FlightRecorder  # noqa: F401
from .capacity import CapacityMeter, CapacityModel, HostGapTracker  # noqa: F401
from .profiler import ProfileBusy, TorchProfiler, XlaProfiler  # noqa: F401
