from .. import launches, reset_launches  # noqa: F401
from .ops import (  # noqa: F401
    PairTables,
    mccm_latency,
    mccm_latency_cuda,
    pair_tables,
    parallelism_search,
    parallelism_search_cuda,
    set_fault_hook,
)
from .ref import mccm_latency_ref, parallelism_search_ref  # noqa: F401
