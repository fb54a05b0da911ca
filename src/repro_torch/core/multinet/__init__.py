"""Multi-CNN co-scheduling on the port: the joint cost model and the
deployment-aware DSE for multi-tenant FPGA boards.

Three layers over the single-model MCCM stack:

* :mod:`~repro_torch.core.multinet.partition`: spatial DSP/BRAM/bandwidth
  splits (repair on the device), temporal round-robin time shares, and
  the hybrid slice structure (dedicated spatial slices + one
  time-multiplexed shared slice, per row);
* :mod:`~repro_torch.core.multinet.joint_eval`: the per-model tables of a
  deployment and the joint evaluator for all three co-execution modes,
  one batch-path call per model lane, producing system metrics (aggregate
  throughput, worst-model latency, fairness, SLO attainment, off-chip
  traffic);
* :mod:`~repro_torch.core.multinet.search` / ``driver``: joint DSE over
  (per-model budget split × per-model CE arrangement × spatial/shared
  assignment), Pareto over system metrics, with equal-split, temporal and
  hybrid arms plus the SLO-driven objective (``Session.deploy``).

The port of the JAX package's ``core/multinet``, with the device twins
named ``*_torch``.  The deprecated ``joint_explore`` shim is not ported.
"""
from .driver import JointDSEResult
from .joint_eval import (
    DEADLINE_SCALES,
    JOINT_TILE,
    MultiNetTables,
    joint_evaluate,
    make_multi_tables,
    slo_attainment_dist,
)
from .partition import (
    BUF_GRANULE,
    DEFAULT_FLOORS,
    DEFAULT_MAX_M,
    PartitionBatch,
    equal_shares,
    gather_slices,
    partition_devices,
    repair_partition_torch,
    repair_time_shares_torch,
    sample_shares,
    slice_masks,
    slice_shares,
    validate_partition,
)
from .search import (
    JOINT_OBJECTIVES,
    SLO_OBJECTIVES,
    MultinetSearchConfig,
    MultinetSearchResult,
    joint_search,
)

__all__ = [
    "BUF_GRANULE",
    "DEADLINE_SCALES",
    "DEFAULT_FLOORS",
    "DEFAULT_MAX_M",
    "JOINT_OBJECTIVES",
    "JOINT_TILE",
    "JointDSEResult",
    "MultiNetTables",
    "MultinetSearchConfig",
    "MultinetSearchResult",
    "PartitionBatch",
    "SLO_OBJECTIVES",
    "equal_shares",
    "gather_slices",
    "joint_evaluate",
    "joint_search",
    "make_multi_tables",
    "partition_devices",
    "repair_partition_torch",
    "repair_time_shares_torch",
    "sample_shares",
    "slice_masks",
    "slice_shares",
    "slo_attainment_dist",
    "validate_partition",
]
