from .. import launches, reset_launches  # noqa: F401
from .ops import (  # noqa: F401
    NPLS,
    LatencyPlan,
    PairTables,
    SearchPlan,
    last_latency_launch,
    last_launch,
    latency_launch_plan,
    latency_plan,
    mccm_latency,
    mccm_latency_cuda,
    pair_tables,
    parallelism_search,
    parallelism_search_cuda,
    search_plan,
    set_fault_hook,
)
from .ref import mccm_latency_ref, parallelism_search_ref  # noqa: F401
