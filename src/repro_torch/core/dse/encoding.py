"""Design encoding: fixed-shape tensors <-> AcceleratorSpec.

The batch evaluator speaks one (B, NS) encoding:

* ``seg_end``   int32 (B, NS): exclusive end layer of each segment, sorted
  nondecreasing; padding columns repeat ``n_layers``.
* ``seg_pipe``  bool  (B, NS): segment is a pipelined block.
* ``seg_nce``   int32 (B, NS): CEs of the segment (1 for single-CE).
* ``inter_pipe`` bool (B,): coarse inter-segment pipelining.

Canonical form (what the samplers produce and ``encode_specs`` emits):
segments are compact (no empty segment before a non-empty one), a valid
segment is pipelined iff ``seg_nce > 1``, and padding columns carry
``end == n_layers, nce == 1, pipe == False``.  ``validate_batch`` checks
exactly this plus the NS/NC CE-count bounds, and ``decode_design`` ->
``encode_specs`` round-trips any canonical row bit-exactly.

The same encoding as the JAX package's ``core/dse/encoding.py``, with the
tensors on an explicit device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..notation import AcceleratorSpec, SegmentSpec

NS = 12          # max segments per design
NC = 16          # max CEs per design


@dataclass
class DesignBatch:
    """(B, NS) tensors on one device; invalid segments have end == previous
    end."""

    seg_end: torch.Tensor       # int32 (B, NS) exclusive end layer
    seg_pipe: torch.Tensor      # bool  (B, NS)
    seg_nce: torch.Tensor       # int32 (B, NS) >= 1
    inter_pipe: torch.Tensor    # bool  (B,)

    @property
    def batch(self) -> int:
        """Number of designs in the batch."""
        return self.seg_end.shape[0]

    @classmethod
    def from_numpy(cls, seg_end, seg_pipe, seg_nce, inter_pipe, *,
                   device="cpu") -> "DesignBatch":
        """Host arrays -> DesignBatch on ``device`` with canonical dtypes."""
        t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt,
                                       device=device)
        return cls(t(seg_end, torch.int32), t(seg_pipe, torch.bool),
                   t(seg_nce, torch.int32), t(inter_pipe, torch.bool))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """(seg_end, seg_pipe, seg_nce, inter_pipe) as host arrays."""
        return tuple(a.cpu().numpy() for a in (
            self.seg_end, self.seg_pipe, self.seg_nce, self.inter_pipe))

    def take(self, idx) -> "DesignBatch":
        """Row subset (a slice or an index tensor)."""
        return DesignBatch(self.seg_end[idx], self.seg_pipe[idx],
                           self.seg_nce[idx], self.inter_pipe[idx])

    def to(self, device) -> "DesignBatch":
        """The same batch on ``device`` (no copy when already there)."""
        return DesignBatch(self.seg_end.to(device), self.seg_pipe.to(device),
                           self.seg_nce.to(device),
                           self.inter_pipe.to(device))


def encode_specs(specs: list[AcceleratorSpec], n_layers: int, *,
                 device="cpu") -> DesignBatch:
    """AcceleratorSpecs -> one canonical (B, NS) DesignBatch (the inverse
    of :func:`decode_design`; round-trips bit-exactly)."""
    B = len(specs)
    seg_end = np.full((B, NS), n_layers, np.int32)
    seg_pipe = np.zeros((B, NS), bool)
    seg_nce = np.ones((B, NS), np.int32)
    inter = np.zeros((B,), bool)
    for b, spec in enumerate(specs):
        if len(spec.segments) > NS:
            raise ValueError(f"{spec.name}: more than {NS} segments")
        end = 0
        for s, seg in enumerate(spec.segments):
            end = seg.layer_hi + 1
            seg_end[b, s] = end
            seg_pipe[b, s] = seg.pipelined
            seg_nce[b, s] = seg.n_ces
        seg_end[b, len(spec.segments):] = end
        inter[b] = spec.inter_segment_pipelining
    return DesignBatch.from_numpy(seg_end, seg_pipe, seg_nce, inter,
                                  device=device)


def decode_design(batch: DesignBatch, i: int,
                  n_layers: int) -> AcceleratorSpec:
    """Row i of a DesignBatch -> AcceleratorSpec (for the scalar evaluator
    or for pretty-printing in the paper's notation)."""
    seg_end, seg_pipe, seg_nce, inter = (
        a[0] for a in batch.take(slice(i, i + 1)).to_numpy())
    segs, lo, ce = [], 0, 0
    for s in range(NS):
        hi = int(seg_end[s])
        if hi <= lo:
            continue
        n = int(seg_nce[s]) if seg_pipe[s] else 1
        segs.append(SegmentSpec(lo, hi - 1, ce, ce + n - 1))
        ce += n
        lo = hi
        if hi >= n_layers:
            break
    return AcceleratorSpec(name=f"custom[{i}]", segments=tuple(segs),
                           inter_segment_pipelining=bool(inter))


def decode_batch(batch: DesignBatch,
                 n_layers: int) -> list[AcceleratorSpec]:
    """Decode every row of a DesignBatch (see :func:`decode_design`)."""
    return [decode_design(batch, i, n_layers) for i in range(batch.batch)]


def validate_batch(batch: DesignBatch, n_layers: int, *,
                   min_ces: int = 1, max_ces: int = NC) -> np.ndarray:
    """Per-row canonical-form + constraint check -> bool mask (B,).

    A row is valid iff its segments are a compact, nondecreasing partition
    of [0, n_layers); ``pipe`` agrees with ``nce > 1`` on valid segments;
    padding carries (n_layers, 1, False); and the total CE count lies in
    [min_ces, min(max_ces, NC)].
    """
    seg_end, seg_pipe, seg_nce, _ = batch.to_numpy()
    prev = np.concatenate(
        [np.zeros((seg_end.shape[0], 1), seg_end.dtype), seg_end[:, :-1]],
        axis=1)
    d = seg_end - prev
    active = d > 0
    ok = (d >= 0).all(1)
    ok &= (seg_end[:, -1] == n_layers) & (seg_end[:, 0] >= 1)
    ok &= (seg_end <= n_layers).all(1)
    # compact: once a segment is empty, all later ones are empty too
    ok &= ~(active & ~np.logical_and.accumulate(active, axis=1)).any(1)
    ok &= (seg_nce >= 1).all(1)
    ok &= (seg_pipe == ((seg_nce > 1) & active)).all(1)
    ok &= (np.where(active, 1, seg_nce) == 1).all(1)   # padding nce == 1
    total = (seg_nce * active).sum(1)
    ok &= (total >= min_ces) & (total <= min(max_ces, NC))
    return ok
