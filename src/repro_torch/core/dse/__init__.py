"""Design-space exploration of the port (paper §V-E, use case 3).

The layers of the JAX package's ``core/dse`` over one shared design
encoding: ``encoding`` (``DesignBatch``, spec round trip, validity and
repair), ``samplers`` (the custom and mixed families), ``pareto`` (fronts
and the incremental archive), ``search`` (the guided loop) and ``driver``
(``Session.explore``'s random sweep and search).

The multi-model encoding (``MultiDesignBatch``, ``stack_designs``,
``pad_plane``, ``pad_deployments``, ``sample_assign``) serves
``core.multinet``.  Not re-exported, because not ported: the deprecated
``explore`` shim and the per-design reference samplers
(``sample_custom_loop``, ``sample_mixed_loop``).
"""
from .driver import (DEFAULT_OBJECTIVES, DSEResult, best_scalar_index,
                     dominating_indices)
from .encoding import (NC, NS, DesignBatch, MultiDesignBatch,
                       concat_batches, decode_batch, decode_design,
                       encode_specs, pad_deployments, pad_plane,
                       sample_assign, stack_designs, validate_batch)
from .pareto import ParetoArchive, hypervolume_2d, pareto
from .samplers import sample_custom, sample_mixed
from .search import SearchConfig, SearchResult, make_children, orient, search

__all__ = [
    "DEFAULT_OBJECTIVES",
    "DSEResult",
    "DesignBatch",
    "MultiDesignBatch",
    "NC",
    "NS",
    "ParetoArchive",
    "SearchConfig",
    "SearchResult",
    "best_scalar_index",
    "concat_batches",
    "decode_batch",
    "decode_design",
    "dominating_indices",
    "encode_specs",
    "hypervolume_2d",
    "make_children",
    "orient",
    "pad_deployments",
    "pad_plane",
    "pareto",
    "sample_assign",
    "sample_custom",
    "sample_mixed",
    "search",
    "stack_designs",
    "validate_batch",
]
