"""``repro_torch.api``: the front door of the PyTorch port.

    from repro_torch.api import Session, get_board, get_cnn

    ses = Session(get_board("zcu102"))                # on the card
    out = ses.evaluate([spec_a, spec_b], get_cnn("resnet50"))
    m = ses.evaluate(spec_a, get_cnn("resnet50"))      # scalar Metrics
    print(format_report(ses.explain(spec_a, get_cnn("resnet50"))))
    art = ses.schedule(spec_a, get_cnn("resnet50"))   # ScheduleArtifact
    print(art.to_json())                              # per-layer mappings
    dse = ses.explore(get_cnn("mobilenetv2"), n=100_000, strategy="search")
    front = dse.front_points()                        # (latency, buffer)
    fut = ses.submit(specs, get_cnn("resnet50"))      # queued, megabatched
    job = ses.submit_search(get_cnn("mobilenetv2"), n=100_000, seed=7)
    fr = ses.deploy([get_cnn("resnet50"), get_cnn("mobilenetv2")], n=4096)
    fr.front_points()                                 # multinet front
    ses.close()                                       # or: with Session(...)

``Session(device="cpu")`` runs the plain PyTorch path on the CPU.
"""
from __future__ import annotations

from . import telemetry  # noqa: F401
from .cnn.registry import get_cnn
from .core.dse import DSEResult, SearchConfig, orient, pareto
from .core.multinet import JointDSEResult, MultinetSearchConfig
from .core.resilience import EvalError, load_checkpoint, save_checkpoint
from .core.session import EvalConfig, Session, SessionStats, default_session
from .fpga.boards import get_board
from .schedule import ScheduleArtifact
from .telemetry.report import bottleneck_report, format_report

__all__ = ["DSEResult", "EvalConfig", "EvalError", "JointDSEResult",
           "MultinetSearchConfig", "ScheduleArtifact", "SearchConfig",
           "Session", "SessionStats", "bottleneck_report",
           "default_session", "format_report", "get_board", "get_cnn",
           "load_checkpoint", "orient", "pareto", "save_checkpoint",
           "telemetry"]
