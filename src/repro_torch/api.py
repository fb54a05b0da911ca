"""``repro_torch.api``: the front door of the PyTorch port.

    from repro_torch.api import Session, get_board, get_cnn

    ses = Session(get_board("zcu102"))                # on the card
    out = ses.evaluate([spec_a, spec_b], get_cnn("resnet50"))
    m = ses.evaluate(spec_a, get_cnn("resnet50"))      # scalar Metrics
    print(format_report(ses.explain(spec_a, get_cnn("resnet50"))))

``Session(device="cpu")`` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

from .cnn.registry import get_cnn
from .core.resilience import EvalError
from .core.session import EvalConfig, Session
from .fpga.boards import get_board
from .telemetry.report import bottleneck_report, format_report

__all__ = ["EvalConfig", "EvalError", "Session", "bottleneck_report",
           "format_report", "get_board", "get_cnn"]
