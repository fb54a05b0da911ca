"""Scalar MCCM facade: notation/spec + CNN + board -> Metrics.

The exact (reference) evaluation path, plain Python on the host;
``batch_eval`` mirrors it as tensor code.  The port of the JAX package's
``core/evaluator.py`` without its deprecated ``evaluate_design`` shim: the
entry point is :meth:`repro_torch.api.Session.evaluate` on one design.
"""
from __future__ import annotations

from .accelerator import ConcreteAccelerator, Metrics, evaluate
from .builder import BuilderOptions, build
from .device import DeviceSpec
from .notation import AcceleratorSpec, parse
from .workload import Network


def _evaluate_design(
    design: str | AcceleratorSpec,
    net: Network,
    dev: DeviceSpec,
    opts: BuilderOptions | None = None,
    inter_segment_pipelining: bool = True,
) -> Metrics:
    """Implementation behind ``Session.evaluate`` on one design."""
    return evaluate(build_design(design, net, dev, opts,
                                 inter_segment_pipelining))


def build_design(
    design: str | AcceleratorSpec,
    net: Network,
    dev: DeviceSpec,
    opts: BuilderOptions | None = None,
    inter_segment_pipelining: bool = True,
) -> ConcreteAccelerator:
    # forwards inter_segment_pipelining exactly as _evaluate_design does,
    # so a built accelerator always agrees with its evaluated metrics
    if isinstance(design, str):
        spec = parse(design, len(net),
                     inter_segment_pipelining=inter_segment_pipelining)
    else:
        spec = design
    return build(spec, net, dev, opts)
