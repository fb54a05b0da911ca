"""Resource partitioning for multi-CNN co-scheduling: the co-execution
modes of a shared FPGA (Shen et al.'s resource-partitioning design space,
arXiv:1607.00064, made analytic).

* **spatial**: the board's DSPs, BRAM and off-chip bandwidth are split
  into M disjoint slices, one multiple-CE accelerator each.  Splits are
  integer (DSPs; BRAM in 1-KiB granules) and computed on the device:
  ``repair_partition_torch`` turns arbitrary positive shares into a valid
  split, so the joint DSE mutates raw shares freely.
* **temporal**: one full-board accelerator per model, time-multiplexed by
  weighted round-robin; ``repair_time_shares_torch`` normalizes the slice
  weights the same way.
* **hybrid**: each model either owns a dedicated spatial slice or is a
  member of the row's single time-multiplexed *shared slice*.  The (B, M)
  assignment is folded into slice-level masks and shares by
  ``slice_masks`` / ``slice_shares``; the shared slice is represented by
  its first member column (the *leader*), the spatial repair runs over
  slice columns, and ``gather_slices`` maps every model back to its
  slice's resources.  An all-spatial assignment reduces bit for bit to the
  spatial mode, an all-shared one to the temporal mode (the single
  remaining slice takes the board verbatim).

The port of the JAX package's ``core/multinet/partition.py``, as tensor
code on the shares' device.  The integer splits are discrete choices, so
they must equal the JAX package's bit for bit: every sum over the model
axis runs left to right (``batch_eval._seq_sum``, the order of XLA's CPU
reduction), argsorts are stable (ties to the first column), and every
constant is float32.  Host-side twins (``sample_shares``,
``equal_shares``, ``validate_partition``, ``dse.sample_assign``) feed the
search and the tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..batch_eval import DEVICE_TABLE_FIELDS, DeviceTables, _seq_sum

F32 = torch.float32

#: model-axis padding: deployments of 1..MAX_M models share one set of
#: shapes (the model axis is padded, never a shape change)
DEFAULT_MAX_M = 4

#: BRAM split granularity (bytes).  Multi-model splits allocate whole
#: granules: physical BRAM comes in blocks, and granule totals stay exact
#: in f32 where raw byte counts (> 2^24) would not.
BUF_GRANULE = 1024

#: default per-model resource floors, as fractions of the board budget:
#: repair never starves a co-resident model below its floor
DEFAULT_FLOORS = (0.05, 0.05, 0.05)   # (pes, buf, bw)


@dataclass
class PartitionBatch:
    """(B, M) per-deployment resource split: integer DSPs, integer BRAM
    bytes (1-KiB granules), and off-chip bandwidth fractions, f32 tensors
    on one device.  Invalid (padded) model columns carry zeros."""

    pes: torch.Tensor   # f32 (B, M) integer-valued DSP split
    buf: torch.Tensor   # f32 (B, M) integer-valued BRAM bytes
    bw: torch.Tensor    # f32 (B, M) bandwidth fractions, sum 1 over valid

    @property
    def batch(self) -> int:
        """Number of deployment rows."""
        return self.pes.shape[0]

    @property
    def n_models(self) -> int:
        """Padded model-axis length of the split tensors."""
        return self.pes.shape[1]

    def take(self, idx) -> "PartitionBatch":
        """Row subset."""
        return PartitionBatch(self.pes[idx], self.buf[idx], self.bw[idx])

    def to_numpy(self):
        """(pes, buf, bw) as host arrays."""
        return tuple(a.cpu().numpy() for a in (self.pes, self.buf, self.bw))


def _proportional_split(shares, total, valid, floor_frac: float):
    """Largest-remainder split of an integer ``total`` (0-d f32)
    proportional to ``shares`` (B, M), each valid model floored at
    ``floor_frac * total``.

    Sums exactly to ``total`` on every row; invalid columns get 0.  Rows
    with a single valid model get the whole budget verbatim (the M=1
    reduction to the single-model evaluator, bit for bit).
    """
    valid_f = valid.to(F32)
    nv = torch.clamp_min(_seq_sum(valid_f), 1.0)[:, None]      # (B, 1)
    fl = torch.floor(torch.minimum(floor_frac * total,
                                   torch.floor(total / nv)))   # (B, 1)
    rem_total = total - fl * nv                                # (B, 1)
    s = torch.where(shares > 0, shares, 0.0) * valid_f
    ssum = _seq_sum(s)[:, None]
    s = torch.where(ssum > 0, s / torch.clamp_min(ssum, 1e-30),
                    valid_f / nv)
    raw = s * rem_total
    base = torch.floor(raw)
    short = rem_total[:, 0] - _seq_sum(base * valid_f)         # (B,)
    frac = torch.where(valid, raw - base, -1.0)
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    bonus = (rank < short[:, None]) & valid
    out = (fl + base + bonus.to(F32)) * valid_f
    # single-model rows take the budget verbatim (no floor/granule detour)
    single = (_seq_sum(valid_f)[:, None] == 1.0) & valid
    return torch.where(single, total.expand(out.shape), out)


def _as_mask(model_valid, shape, device) -> torch.Tensor:
    """(M,) model validity or an explicit (B, M) per-row mask -> (B, M)
    bool on ``device``.  The 1-D form broadcasts one validity row over the
    batch (the spatial/temporal modes); the 2-D form carries per-row slice
    structure (the hybrid mode)."""
    mv = torch.as_tensor(model_valid, device=device)
    if mv.dim() == 2:
        return mv if mv.dtype == torch.bool else mv > 0
    return (mv > 0)[None, :].expand(shape)


def repair_partition_torch(pes_shares, buf_shares, bw_shares,
                           dev: DeviceTables, model_valid,
                           floors=DEFAULT_FLOORS) -> PartitionBatch:
    """Spatial-split repair: arbitrary positive (B, M) shares -> a valid
    :class:`PartitionBatch` for board ``dev`` (0-d ``DeviceTables``), the
    JAX package's ``repair_partition_jax`` bit for bit.

    Guarantees, per row (over valid columns):
    * ``pes`` are integers summing exactly to ``dev.pes``;
    * ``buf`` are 1-KiB multiples summing exactly to the board's BRAM
      rounded down to the granule (single-column rows take the full budget);
    * ``bw`` fractions sum to 1;
    * every valid column receives at least its ``floors`` fraction (clamped
      to an equal split when M * floor > 1).

    ``model_valid`` is the (M,) model mask or, for hybrid deployments, a
    per-row (B, M) *slice* mask (see :func:`slice_masks`).
    """
    valid = _as_mask(model_valid, pes_shares.shape, pes_shares.device)
    valid_f = valid.to(F32)
    pes = _proportional_split(pes_shares, dev.pes, valid, floors[0])
    buf_g = _proportional_split(
        buf_shares, torch.floor(dev.on_chip_bytes / BUF_GRANULE), valid,
        floors[1])
    single = (_seq_sum(valid_f)[:, None] == 1.0) & valid
    buf = torch.where(single, dev.on_chip_bytes.expand(buf_g.shape),
                      buf_g * BUF_GRANULE)
    bw = repair_time_shares_torch(bw_shares, model_valid, floor=floors[2])
    return PartitionBatch(pes, buf, bw)


def repair_time_shares_torch(raw, model_valid, floor: float = 0.05):
    """Share normalization: positive (B, M) raw weights -> fractions
    summing to 1 over valid columns, each at least ``floor`` (clamped to an
    equal split when M * floor > 1), the JAX package's
    ``repair_time_shares_jax``.  Used for bandwidth fractions (spatial),
    round-robin time slices (temporal), and, with a per-row (B, M)
    membership mask, the time shares within a hybrid shared slice.  Rows
    with an all-False mask return zeros."""
    valid = _as_mask(model_valid, raw.shape, raw.device)
    valid_f = valid.to(F32)
    nv = torch.clamp_min(_seq_sum(valid_f), 1.0)[:, None]
    fl = torch.clamp_max(1.0 / nv, floor)
    s = torch.where(raw > 0, raw, 0.0) * valid_f
    ssum = _seq_sum(s)[:, None]
    s = torch.where(ssum > 0, s / torch.clamp_min(ssum, 1e-30),
                    valid_f / nv)
    return (fl + (1.0 - nv * fl) * s) * valid_f


def partition_devices(dev: DeviceTables, part: PartitionBatch,
                      model_valid) -> DeviceTables:
    """Per-(row, model) boards for the spatial mode: every leaf is (B, M)
    (take lane m with :func:`lane_devices`).  Invalid (padded) model
    columns get the FULL board: their metrics are numerically safe and
    masked out of every system metric."""
    valid = _as_mask(model_valid, part.pes.shape, part.pes.device)
    full = lambda x: x.expand(part.pes.shape)
    return DeviceTables(
        pes=torch.where(valid, part.pes, full(dev.pes)),
        on_chip_bytes=torch.where(valid, part.buf, full(dev.on_chip_bytes)),
        bpc=torch.where(valid, part.bw * dev.bpc, full(dev.bpc)),
        bps=torch.where(valid, part.bw * dev.bps, full(dev.bps)),
        clock_hz=full(dev.clock_hz).contiguous(),
        wordbytes=full(dev.wordbytes).contiguous())


def lane_devices(devs: DeviceTables, m: int) -> DeviceTables:
    """Lane m of (B, M) per-(row, model) boards: one board per row, the
    ``(B,)`` ``DeviceTables`` the batch path takes."""
    return DeviceTables(*(getattr(devs, k)[:, m].contiguous()
                          for k in DEVICE_TABLE_FIELDS))


# --------------------------------------------------------------------------
# hybrid deployments: per-row spatial-slice / shared-slice structure
# --------------------------------------------------------------------------
def slice_masks(assign, model_valid):
    """Slice structure of a hybrid deployment batch.

    ``assign`` is the (B, M) deployment assignment (see
    ``dse.encoding.sample_assign``): values > 0.5 mark membership in the
    row's single time-multiplexed *shared slice*; every other valid model
    owns a dedicated spatial slice.  Returns ``(shared, slice_valid,
    slice_col)``:

    * ``shared``      (B, M) bool: model is a shared-slice member;
    * ``slice_valid`` (B, M) bool: column represents a slice in the
      spatial split: every dedicated model plus the shared slice's
      *leader* (its first member column);
    * ``slice_col``   (B, M) int64: the column model m draws its slice
      resources from (itself when dedicated, the leader when shared).
    """
    valid = _as_mask(model_valid, assign.shape, assign.device)
    shared = (assign > 0.5) & valid
    is_leader = shared & (torch.cumsum(shared.to(torch.int32), dim=-1) == 1)
    slice_valid = (valid & ~shared) | is_leader
    leader_col = torch.argmax(is_leader.to(torch.int32), dim=-1)   # (B,)
    cols = torch.arange(assign.shape[1], device=assign.device)[None, :]
    slice_col = torch.where(shared, leader_col[:, None], cols)
    return shared, slice_valid, slice_col


def slice_shares(raw, shared, slice_valid):
    """Fold model-level raw resource shares into slice-level shares: the
    shared slice (its leader column) claims the sum of its members'
    positive shares, dedicated columns keep their own, non-leader shared
    columns zero.  With no shared members this returns ``raw`` unchanged:
    the all-spatial reduction stays bit for bit."""
    pos = torch.where(raw > 0, raw, 0.0) * shared.to(raw.dtype)
    pooled = _seq_sum(pos)[:, None]
    return torch.where(shared,
                       torch.where(slice_valid, pooled,
                                   torch.zeros_like(raw)),
                       raw)


def gather_slices(part: PartitionBatch, slice_col) -> PartitionBatch:
    """Map a slice-level :class:`PartitionBatch` back to the per-model
    view: model m's columns become its slice's resources (shared members
    all see the full shared slice: they time-multiplex within it)."""
    g = lambda a: torch.take_along_dim(a, slice_col, dim=1)
    return PartitionBatch(g(part.pes), g(part.buf), g(part.bw))


# --------------------------------------------------------------------------
# host-side helpers (search init, baselines, tests)
# --------------------------------------------------------------------------
def sample_shares(rng: np.random.Generator, n: int, max_m: int,
                  n_models: int | None = None) -> np.ndarray:
    """(n, max_m) random positive shares (Dirichlet over the real models,
    zeros on padded columns): the raw genome the repair consumes."""
    m = max_m if n_models is None else n_models
    out = np.zeros((n, max_m), np.float32)
    out[:, :m] = rng.dirichlet(np.ones(m), size=n).astype(np.float32)
    return out


def equal_shares(n: int, max_m: int,
                 n_models: int | None = None) -> np.ndarray:
    """(n, max_m) equal shares over the real models: the equal-split
    baseline's frozen genome."""
    m = max_m if n_models is None else n_models
    out = np.zeros((n, max_m), np.float32)
    out[:, :m] = 1.0 / m
    return out


def validate_partition(part: PartitionBatch, dev, model_valid,
                       floors=DEFAULT_FLOORS) -> np.ndarray:
    """Host-side check of the repair guarantees -> bool mask (B,).

    ``dev`` is a DeviceSpec (exact host integers).  Budgets are compared
    against the f32 board values the device path sees.
    """
    pes, buf, bw = part.to_numpy()
    valid = np.asarray(model_valid.cpu() if isinstance(
        model_valid, torch.Tensor) else model_valid) > 0
    nv = int(valid.sum())
    pes_total = float(np.float32(dev.pes))
    buf_total = float(np.float32(dev.on_chip_bytes))
    ok = np.abs((pes * valid[None, :]).sum(-1) - pes_total) < 0.5
    if nv == 1:
        ok &= np.abs((buf * valid[None, :]).sum(-1) - buf_total) < 0.5
    else:
        gran_total = np.floor(buf_total / BUF_GRANULE) * BUF_GRANULE
        ok &= np.abs((buf * valid[None, :]).sum(-1) - gran_total) < 0.5
    ok &= np.abs((bw * valid[None, :]).sum(-1) - 1.0) < 1e-5
    fl_pes = np.floor(min(floors[0], 1.0 / nv) * pes_total)
    fl_buf = np.floor(min(floors[1], 1.0 / nv)
                      * np.floor(buf_total / BUF_GRANULE)) * BUF_GRANULE
    fl_bw = min(floors[2], 1.0 / nv)
    ok &= (pes[:, valid] >= fl_pes - 0.5).all(-1)
    ok &= (buf[:, valid] >= fl_buf - 0.5).all(-1)
    ok &= (bw[:, valid] >= fl_bw - 1e-6).all(-1)
    ok &= (pes[:, ~valid] == 0).all(-1)    # padded columns stay zeroed
    ok &= (buf[:, ~valid] == 0).all(-1)
    ok &= (bw[:, ~valid] == 0).all(-1)
    return ok
