"""Observability of the port: the spans, metrics registry and exporters of
:mod:`repro_torch.core.telemetry`, and the bottleneck-attribution report
(:mod:`repro_torch.telemetry.report`) that turns a scalar ``Metrics``
breakdown into the paper's use-case-2 ranked tables.

    from repro_torch import telemetry
    telemetry.enable("/tmp/traces")       # or REPRO_TELEMETRY_DIR=...
    with telemetry.span("my.stage"):
        ...
    print(telemetry.prometheus_text())
"""
from __future__ import annotations

from ..core.telemetry import (DEFAULT_BUCKETS, PROFILE_ENV,  # noqa: F401
                              TELEMETRY_DIR_ENV, Histogram, count,
                              current_span, disable, enable, enabled,
                              event, gauge, observe, profile,
                              prometheus_text, read_trace, reset,
                              snapshot, span, trace_path,
                              validate_trace_line)
from .report import bottleneck_report, format_report  # noqa: F401

__all__ = [
    "DEFAULT_BUCKETS", "Histogram", "PROFILE_ENV", "TELEMETRY_DIR_ENV",
    "bottleneck_report", "count", "current_span", "disable", "enable",
    "enabled", "event", "format_report", "gauge", "observe", "profile",
    "prometheus_text", "read_trace", "reset", "snapshot", "span",
    "trace_path", "validate_trace_line",
]
