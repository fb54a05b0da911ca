"""Schedule layer: per-CE temporal-mapping search under every evaluated
design.

``search`` scores the candidate plane on the tables' device (the card or
the CPU) and re-composes refined metrics through the same Eq. 2–9
reduction; ``artifact`` decodes the result into the JSON-serializable
:class:`ScheduleArtifact` that ``Session.schedule`` returns.
"""
from .artifact import (CEPlan, LayerSchedule, ScheduleArtifact,  # noqa: F401
                       SegmentCost, build_artifact, energy_proxy)
from .search import (coarse_state, device_plane,  # noqa: F401
                     plane_inputs, plane_of_state, schedule_batch,
                     schedule_specs)

__all__ = [
    "CEPlan", "LayerSchedule", "ScheduleArtifact", "SegmentCost",
    "build_artifact", "coarse_state", "device_plane", "energy_proxy",
    "plane_inputs", "plane_of_state", "schedule_batch", "schedule_specs",
]
