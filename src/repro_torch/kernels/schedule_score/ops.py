"""Routing and candidate metadata of the schedule scorer.

The scorer (``ref.score_plane``) is torch tensor code, not a hand-written
kernel: the JAX package never wrote it in Pallas.  The tensor's device
picks where it runs, the CPU or the card; there is no backend knob and no
fallback from the card to the CPU.
"""
from __future__ import annotations

from .ref import CAND_META, ORDER_NAMES, score_plane

#: test-only fault-injection hook: when set, called as
#: ``hook("schedule_score", route)`` at every scoring, ``route`` the
#: inputs' device type ("cuda" or "cpu"); a raising hook aborts the call
_FAULT_HOOK = None


def set_fault_hook(hook):
    """Install (or, with ``None``, uninstall) the fault-injection hook;
    returns the previous hook so tests can restore it."""
    global _FAULT_HOOK
    prev, _FAULT_HOOK = _FAULT_HOOK, hook
    return prev


def score_plane_dispatch(**inputs):
    """Score the candidate plane on the inputs' device."""
    if _FAULT_HOOK is not None:
        _FAULT_HOOK("schedule_score", inputs["comp"].device.type)
    return score_plane(**inputs)


def candidate_meta(index: int) -> tuple[str, float, bool]:
    """(order_name, tile_frac, double_buffer) for a candidate index."""
    order_id, frac, db = CAND_META[int(index)]
    return ORDER_NAMES[order_id], float(frac), bool(db)


def decode_candidate(index: int) -> dict:
    """Argmin index -> JSON-ready mapping description."""
    order, frac, db = candidate_meta(index)
    return {"order": order, "tile_frac": frac, "double_buffer": db}
