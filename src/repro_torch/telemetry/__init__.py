"""Observability of the port: so far the bottleneck-attribution report
(:mod:`repro_torch.telemetry.report`) that turns a scalar ``Metrics``
breakdown into the paper's use-case-2 ranked tables.  Spans, the metrics
registry and the exporters of the JAX package's ``core/telemetry.py`` are
still to be ported.
"""
from __future__ import annotations

from .report import bottleneck_report, format_report  # noqa: F401

__all__ = ["bottleneck_report", "format_report"]
