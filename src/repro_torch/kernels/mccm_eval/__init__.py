from .ops import (  # noqa: F401
    PairTables,
    launches,
    pair_tables,
    parallelism_search,
    parallelism_search_cuda,
    reset_launches,
    set_fault_hook,
)
from .ref import parallelism_search_ref  # noqa: F401
