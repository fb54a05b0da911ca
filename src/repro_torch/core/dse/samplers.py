"""Vectorized design samplers: a whole DesignBatch from a handful of
batched NumPy RNG calls (random contiguous partitions via per-row key
sorting, CE allocation via balls-into-bins ``bincount``).

A copy of the JAX package's ``core/dse/samplers.py`` (the same seed gives
the same designs); the batch is built on the host and placed on
``device``.

Families (paper §V-E, use case 3):
``sample_custom`` — pipelined first block (one CE per layer), then 1..k
                    single-CE segments, coarse pipelining between;
``sample_mixed``  — superset family: every segment independently single
                    or pipelined (contains all three templates).
"""
from __future__ import annotations

import numpy as np

from .encoding import NC, NS, DesignBatch


def _rand_partitions(rng: np.random.Generator, hi: np.ndarray,
                     n_parts: np.ndarray, width: int) -> np.ndarray:
    """Batched random contiguous partitions.

    For each row i, draw ``n_parts[i] - 1`` distinct sorted cut points in
    [1, hi[i] - 1] and return the exclusive part ends padded with
    ``hi[i]``: an int32 (n, width) nondecreasing array whose first
    ``n_parts[i]`` entries end the parts (the last of them == hi[i]).
    """
    n = len(hi)
    hi = np.maximum(hi, 1)
    n_parts = np.clip(n_parts, 1, np.minimum(hi, width))
    max_cuts = int(min(width - 1, max(int(hi.max()) - 1, 0),
                       max(int(n_parts.max()) - 1, 1) if len(n_parts) else 1))
    if max_cuts == 0 or len(hi) == 0:
        return np.repeat(hi[:, None], width, axis=1).astype(np.int32)
    # positions 1..hi-1 get random keys; the n_parts-1 smallest keys win.
    # argpartition to the <= NS-1 winners, then rank just those few columns
    # (a full stable argsort of the key matrix costs 3x more).
    keys = rng.random((n, int(hi.max()) - 1), dtype=np.float32)
    if (hi != hi[0]).any():             # constant hi: every position valid
        pos = np.arange(1, keys.shape[1] + 1)
        keys[pos[None, :] > (hi - 1)[:, None]] = np.inf
    if max_cuts < keys.shape[1]:
        part = np.argpartition(keys, max_cuts - 1, axis=1)[:, :max_cuts]
    else:
        part = np.broadcast_to(np.arange(max_cuts), (n, max_cuts))
    sel_keys = np.take_along_axis(keys, part, axis=1)
    order = np.take_along_axis(part, np.argsort(sel_keys, axis=1), axis=1)
    cuts = (order + 1).astype(np.int64)
    # keep only the first n_parts-1 cuts, pad the rest with hi
    cuts = np.where(np.arange(max_cuts)[None, :] < (n_parts - 1)[:, None],
                    cuts, hi[:, None])
    cuts.sort(axis=1)
    ends = np.full((n, width), 0, np.int64)
    ends[:, :max_cuts] = cuts
    ends[:, max_cuts:] = hi[:, None]
    return ends.astype(np.int32)


def _balls_into_bins(rng: np.random.Generator, n_balls: np.ndarray,
                     n_bins: np.ndarray, width: int) -> np.ndarray:
    """Row i drops ``n_balls[i]`` balls u.a.r. into its first ``n_bins[i]``
    bins; returns int64 counts (n, width).  Matches the seed loop's
    one-increment-at-a-time distribution (multinomial, equal p)."""
    n = len(n_balls)
    m = int(n_balls.max()) if n else 0
    if n == 0 or m == 0:
        return np.zeros((n, width), np.int64)
    bins = rng.integers(0, np.maximum(n_bins, 1)[:, None], size=(n, m))
    live = np.arange(m)[None, :] < n_balls[:, None]
    flat = (np.arange(n)[:, None] * width + bins)[live]
    return np.bincount(flat, minlength=n * width).reshape(n, width)


def sample_custom(rng: np.random.Generator, n_layers: int, n: int,
                  min_ces: int = 2, max_ces: int = 11, *,
                  device="cpu") -> DesignBatch:
    """The paper's custom family: pipelined first block (one CE per layer),
    then 1..k single-CE segments, coarse pipelining between segments."""
    if not 2 <= min_ces <= max_ces <= NC:
        raise ValueError(f"need 2 <= min_ces <= max_ces <= {NC}")
    total = rng.integers(min_ces, max_ces + 1, size=n)
    first = rng.integers(1, total)                 # CEs in the pipelined head
    # degenerate edge: the head (one layer per CE) may not consume every
    # layer — clamp so at least one tail layer remains (unless L == 1)
    first = np.minimum(first, max(n_layers - 1, 1))
    head_end = first.astype(np.int64)
    tail = n_layers - head_end                     # tail layers (>= 0)
    rest = np.clip(total - first, 1, np.maximum(tail, 1))
    ends_tail = head_end[:, None] + _rand_partitions(
        rng, np.maximum(tail, 1), rest, NS - 1)
    ends_tail = np.minimum(ends_tail, n_layers)    # tail == 0 -> all padding
    seg_end = np.concatenate([head_end[:, None], ends_tail], axis=1)
    seg_nce = np.ones((n, NS), np.int32)
    seg_nce[:, 0] = first
    seg_pipe = np.zeros((n, NS), bool)
    seg_pipe[:, 0] = first > 1
    return DesignBatch.from_numpy(seg_end, seg_pipe, seg_nce,
                                  np.ones((n,), bool), device=device)


def sample_mixed(rng: np.random.Generator, n_layers: int, n: int,
                 min_ces: int = 2, max_ces: int = 11,
                 max_segments: int = 6, *, device="cpu") -> DesignBatch:
    """Superset family: each segment independently single or pipelined."""
    if not 1 <= min_ces <= max_ces <= NC:
        raise ValueError(f"need 1 <= min_ces <= max_ces <= {NC}")
    total = rng.integers(min_ces, max_ces + 1, size=n)
    cap = np.minimum(np.minimum(max_segments, total),
                     min(n_layers, NS))
    n_seg = rng.integers(1, cap + 1)
    seg_end = _rand_partitions(rng, np.full(n, n_layers, np.int64), n_seg, NS)
    alloc = 1 + _balls_into_bins(rng, total - n_seg, n_seg, NS)
    cols = np.arange(NS)[None, :]
    active = cols < n_seg[:, None]
    seg_nce = np.where(active, alloc, 1).astype(np.int32)
    seg_pipe = active & (seg_nce > 1)
    inter = (n_seg > 1) & (rng.integers(0, 2, size=n) > 0)
    return DesignBatch.from_numpy(seg_end, seg_pipe, seg_nce, inter,
                                  device=device)
