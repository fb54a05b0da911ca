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

Multi-model deployments (``core.multinet``) extend the encoding along a
model axis: :class:`MultiDesignBatch` stacks M per-model design planes
into (B, M, NS) tensors, and a hybrid deployment adds the **assignment**
plane, a float (B, M) array where ``assign[b, m] > 0.5`` places model m in
deployment b's single time-multiplexed *shared slice* and anything else
gives it a dedicated spatial slice (``sample_assign`` draws them).

The same encoding as the JAX package's ``core/dse/encoding.py``, with the
tensors on an explicit device.  :func:`validate_batch_torch` and
:func:`repair_batch_torch` are the device twins of its
``validate_batch_jax`` and ``repair_batch_jax``: tensor code on the
batch's device, which the guided search runs on every generation.
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


def concat_batches(batches: list[DesignBatch]) -> DesignBatch:
    """Row-concatenate DesignBatches (all for the same n_layers, on one
    device)."""
    return DesignBatch(
        torch.cat([b.seg_end for b in batches]),
        torch.cat([b.seg_pipe for b in batches]),
        torch.cat([b.seg_nce for b in batches]),
        torch.cat([b.inter_pipe for b in batches]))


@dataclass
class MultiDesignBatch:
    """The model-axis extension of :class:`DesignBatch`: row b describes a
    *deployment* of ``n_models`` co-resident accelerators; model m of row
    b runs design ``(seg_end[b, m], ...)`` on its slice of the board.

    Segment tensors are (B, M, NS), ``inter_pipe`` is (B, M), on one
    device.  Each model's plane (:meth:`model`) is a canonical DesignBatch
    for that model's layer count.
    """

    seg_end: torch.Tensor       # int32 (B, M, NS)
    seg_pipe: torch.Tensor      # bool  (B, M, NS)
    seg_nce: torch.Tensor       # int32 (B, M, NS)
    inter_pipe: torch.Tensor    # bool  (B, M)

    @property
    def batch(self) -> int:
        """Number of deployment rows."""
        return self.seg_end.shape[0]

    @property
    def n_models(self) -> int:
        """Padded model-axis length (max_m)."""
        return self.seg_end.shape[1]

    @classmethod
    def from_numpy(cls, seg_end, seg_pipe, seg_nce, inter_pipe, *,
                   device="cpu") -> "MultiDesignBatch":
        """Host arrays -> MultiDesignBatch on ``device``, canonical
        dtypes."""
        d = DesignBatch.from_numpy(seg_end, seg_pipe, seg_nce, inter_pipe,
                                   device=device)
        return cls(d.seg_end, d.seg_pipe, d.seg_nce, d.inter_pipe)

    def model(self, m: int) -> DesignBatch:
        """Model m's plane as a plain (B, NS) DesignBatch."""
        return DesignBatch(self.seg_end[:, m], self.seg_pipe[:, m],
                           self.seg_nce[:, m], self.inter_pipe[:, m])

    def take(self, idx) -> "MultiDesignBatch":
        """Row subset (a slice, an index array or tensor)."""
        return MultiDesignBatch(self.seg_end[idx], self.seg_pipe[idx],
                                self.seg_nce[idx], self.inter_pipe[idx])

    def to_numpy(self):
        """(seg_end, seg_pipe, seg_nce, inter_pipe) as host arrays."""
        return tuple(a.cpu().numpy() for a in (
            self.seg_end, self.seg_pipe, self.seg_nce, self.inter_pipe))

    def to(self, device) -> "MultiDesignBatch":
        """The same deployments on ``device`` (no copy when already
        there)."""
        return MultiDesignBatch(*(a.to(device) for a in (
            self.seg_end, self.seg_pipe, self.seg_nce, self.inter_pipe)))


def stack_designs(batches: list[DesignBatch],
                  max_m: int | None = None) -> MultiDesignBatch:
    """Stack per-model DesignBatches (equal B, one device) into a
    MultiDesignBatch, padding the model axis to ``max_m`` by repeating the
    LAST entry: the rule ``multinet.make_multi_tables`` pads its tables
    by, so padded design planes always pair with matching tables."""
    if not batches:
        raise ValueError("stack_designs needs at least one DesignBatch")
    if len({b.batch for b in batches}) != 1:
        raise ValueError("all model DesignBatches must share one batch size")
    if max_m is None:
        max_m = len(batches)
    if len(batches) > max_m:
        raise ValueError(f"{len(batches)} models exceed max_m={max_m}")
    batches = list(batches) + [batches[-1]] * (max_m - len(batches))
    stack = lambda f: torch.stack([getattr(b, f) for b in batches], dim=1)
    return MultiDesignBatch(stack("seg_end"), stack("seg_pipe"),
                            stack("seg_nce"), stack("inter_pipe"))


def sample_assign(rng: np.random.Generator, n: int, max_m: int,
                  n_models: int | None = None,
                  p_shared: float = 0.5) -> np.ndarray:
    """(n, max_m) random hybrid-deployment assignments: each real model is
    a shared-slice member with probability ``p_shared`` (1.0 on the gene ==
    member, 0.0 == dedicated spatial slice); padded columns stay 0.  The
    assignment twin of ``multinet.sample_shares``, host numpy on the JAX
    package's draws."""
    m = max_m if n_models is None else n_models
    out = np.zeros((n, max_m), np.float32)
    out[:, :m] = (rng.random((n, m)) < p_shared).astype(np.float32)
    return out


def pad_plane(a: torch.Tensor, n: int) -> torch.Tensor:
    """Edge-pad one (B, ...) tensor to ``n`` rows by repeating the last
    row: how the share/assign planes ride along when their deployments are
    padded (``pad_deployments``)."""
    pad = n - a.shape[0]
    if pad <= 0:
        return a
    return torch.cat([a, a[-1:].repeat_interleave(pad, 0)], 0)


def pad_deployments(md: MultiDesignBatch, n: int) -> MultiDesignBatch:
    """Edge-pad a MultiDesignBatch to ``n`` rows (padded rows are
    evaluated and sliced off)."""
    if n <= md.batch:
        return md
    return MultiDesignBatch(pad_plane(md.seg_end, n),
                            pad_plane(md.seg_pipe, n),
                            pad_plane(md.seg_nce, n),
                            pad_plane(md.inter_pipe, n))


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


#: the dtypes the ends and CE counts may take (every integer dtype that
#: torch's elementwise ops and reductions take on both devices)
_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32,
               torch.int64)


def check_planes(batch: DesignBatch) -> None:
    """Raise ``TypeError`` or ``ValueError`` unless ``batch`` is well
    formed: tensors, ``seg_end``, ``seg_pipe`` and ``seg_nce`` of one
    (B, NS) shape and ``inter_pipe`` (B,), integer ends and counts, bool
    flags.  Reads the planes' attributes only, never their data, so it
    costs no copy and no sync on any device; :func:`validate_batch_torch`
    then checks the rows."""
    planes = {"seg_end": batch.seg_end, "seg_pipe": batch.seg_pipe,
              "seg_nce": batch.seg_nce, "inter_pipe": batch.inter_pipe}
    for name, t in planes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"DesignBatch.{name} is a {type(t).__name__}, "
                            f"not a torch.Tensor")
        flag = name.endswith("pipe")
        if t.dtype not in ((torch.bool,) if flag else _INT_DTYPES):
            raise TypeError(f"DesignBatch.{name} has dtype {t.dtype}, not "
                            + ("bool" if flag else "an integer dtype"))
    shape = tuple(batch.seg_end.shape)
    if len(shape) != 2 or shape[1] != NS:
        raise ValueError(f"DesignBatch.seg_end has shape {shape}, not "
                         f"(B, {NS})")
    for name, want in (("seg_pipe", shape), ("seg_nce", shape),
                       ("inter_pipe", shape[:1])):
        if tuple(planes[name].shape) != want:
            raise ValueError(f"DesignBatch.{name} has shape "
                             f"{tuple(planes[name].shape)}, not {want}")


def _prev_end(end: torch.Tensor) -> torch.Tensor:
    """Each segment's start: the previous column's end, 0 for the first."""
    return torch.cat([torch.zeros_like(end[:, :1]), end[:, :-1]], 1)


def validate_batch_torch(batch: DesignBatch, n_layers: int, *,
                         min_ces: int = 1, max_ces: int = NC
                         ) -> torch.Tensor:
    """:func:`validate_batch` as tensor code on the batch's device: a bool
    (B,) tensor, the JAX package's ``validate_batch_jax``.

    The same predicate in fewer passes: the per-segment conditions fold
    into one mask reduced once, compactness reads as no empty segment
    just before a non-empty one (a running product along the segments
    took 0.67 of the check's 0.83 ms on a 100,000-row batch on an H100),
    and ``seg_end[:, 0] >= 1`` is left out: a compact, nondecreasing row
    whose last end is ``n_layers`` (>= 1) has a non-empty first segment.
    """
    seg_end, seg_pipe, seg_nce = batch.seg_end, batch.seg_pipe, batch.seg_nce
    d = seg_end - _prev_end(seg_end)
    active = d > 0
    bad = (d < 0) | (seg_end > n_layers) | (seg_nce < 1) \
        | (seg_pipe != ((seg_nce > 1) & active)) \
        | (~active & (seg_nce != 1))                # padding nce == 1
    bad[:, 1:] |= active[:, 1:] & ~active[:, :-1]   # compact
    total = (seg_nce * active).sum(1)
    return ~bad.any(1) & (seg_end[:, -1] == n_layers) \
        & (total >= min_ces) & (total <= min(max_ces, NC))


#: steps of a repair loop between two checks that the last step changed
#: a row (a step that changes none leaves every later step a no-op)
REPAIR_CHECK_EVERY = 8


def repair_batch_torch(batch: DesignBatch, n_layers: int, *,
                       min_ces: int = 1, max_ces: int = NC) -> DesignBatch:
    """Constraint repair as tensor code on the batch's device: canonicalize
    a batch and clamp its CE totals into [min_ces, min(max_ces, NC)], the
    JAX package's ``repair_batch_jax`` bit for bit.

    The identity on canonical rows (sorting, compaction and both clamp
    loops are no-ops there).  Deterministic: takes from the largest
    segment (the first of equals), gives to the first.  Repair never
    merges segments, so a row with more active segments than ``max_ces``
    stays invalid for :func:`validate_batch_torch` to screen.

    The JAX twin runs NS*NC shrink and 2*NC grow steps as fixed loops.
    Here each loop stops at the first checked step that changes no row
    (checked after the first step, then every ``REPAIR_CHECK_EVERY``):
    the state is then a fixed point, so the result is the same, and a
    canonical batch costs one step and one host sync a loop.
    """
    B = batch.batch
    end0 = batch.seg_end.clamp(0, n_layers)
    end, order = torch.sort(end0, dim=1, stable=True)
    nce = batch.seg_nce.clamp(1, NC).gather(1, order)
    end[:, -1] = n_layers
    active = end > _prev_end(end)
    # compaction: actives first (a stable sort keeps ascending order),
    # padding columns forced to the canonical (n_layers, 1, False)
    inactive, corder = torch.sort((~active).to(torch.uint8), dim=1,
                                  stable=True)
    active_s = inactive == 0
    end = torch.where(active_s, end.gather(1, corder), n_layers)
    nce = torch.where(active_s, nce.gather(1, corder), 1)
    active = end > _prev_end(end)

    cap = min(max_ces, NC)
    floor_ces = min(min_ces, cap)
    rows = torch.arange(B, device=end.device)

    def shrink(nc):
        over = (nc * active).sum(1) > cap
        key = torch.where(active & (nc > 1), nc, -1)
        col = key.argmax(1)                      # the first largest
        hit = over & (key.gather(1, col[:, None])[:, 0] > 0)
        return nc.index_put((rows, col), -hit.to(nc.dtype),
                            accumulate=True), hit

    can_grow = active.any(1)
    first_active = active.to(torch.uint8).argmax(1)

    def grow(nc):
        hit = ((nc * active).sum(1) < floor_ces) & can_grow
        return nc.index_put((rows, first_active), hit.to(nc.dtype),
                            accumulate=True), hit

    # worst case needs NS*NC - cap decrements (all NS segments at nce=NC)
    for step, steps in ((shrink, NS * NC), (grow, 2 * NC)):
        for i in range(steps):
            nce, hit = step(nce)
            if i % REPAIR_CHECK_EVERY == 0 and not bool(hit.any()):
                break
    nce = torch.where(active, nce, 1)
    pipe = (nce > 1) & active
    return DesignBatch(end.to(torch.int32), pipe, nce.to(torch.int32),
                       batch.inter_pipe)
