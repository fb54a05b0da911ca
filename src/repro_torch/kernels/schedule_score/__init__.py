"""Per-layer temporal-mapping candidate scoring (the schedule layer's
scorer): one (B, L, NCAND) plane of MCCM-cost-scored mapping candidates,
argmin-reduced on the plane's device.

``ref.py`` holds the scorer, torch tensor code that runs on the CPU and on
the card alike; ``ops.py`` holds the fault hook and the candidate metadata
used to decode an argmin index back into a mapping.
"""
from .ops import (candidate_meta, decode_candidate,  # noqa: F401
                  score_plane_dispatch, set_fault_hook)
from .ref import (BIG, CAND_DB, CAND_FRAC, CAND_ORDER,  # noqa: F401
                  FRACS, NCAND, ORDER_NAMES, score_plane)

__all__ = [
    "BIG", "CAND_DB", "CAND_FRAC", "CAND_ORDER", "FRACS", "NCAND",
    "ORDER_NAMES", "candidate_meta", "decode_candidate", "score_plane",
    "score_plane_dispatch", "set_fault_hook",
]
