"""The one traffic generator: design batches drawn from a mix's parameters
and a seed, as host arrays.

A design is MCCM's (NS,)-wide encoding: each segment's exclusive end
layer, whether it is a pipelined block, its CE count, and whether the
segments are pipelined among themselves.  A mix names a design family and
its arguments; a family is a frozen copy of one of the MCCM reference's
vectorized samplers (paper §V-E, use case 3).  ``mixed``: each segment
independently single-CE or pipelined.
"""
from __future__ import annotations

import numpy as np

NS, NC = 12, 16


def _rand_partitions(rng, hi, n_parts, width):
    """Row i: ``n_parts[i] - 1`` distinct sorted cut points in
    [1, hi[i] - 1], returned as exclusive part ends padded with hi[i]."""
    n = len(hi)
    hi = np.maximum(hi, 1)
    n_parts = np.clip(n_parts, 1, np.minimum(hi, width))
    max_cuts = int(min(width - 1, max(int(hi.max()) - 1, 0),
                       max(int(n_parts.max()) - 1, 1) if len(n_parts) else 1))
    if max_cuts == 0 or len(hi) == 0:
        return np.repeat(hi[:, None], width, axis=1).astype(np.int32)
    keys = rng.random((n, int(hi.max()) - 1), dtype=np.float32)
    if (hi != hi[0]).any():
        pos = np.arange(1, keys.shape[1] + 1)
        keys[pos[None, :] > (hi - 1)[:, None]] = np.inf
    if max_cuts < keys.shape[1]:
        part = np.argpartition(keys, max_cuts - 1, axis=1)[:, :max_cuts]
    else:
        part = np.broadcast_to(np.arange(max_cuts), (n, max_cuts))
    sel_keys = np.take_along_axis(keys, part, axis=1)
    order = np.take_along_axis(part, np.argsort(sel_keys, axis=1), axis=1)
    cuts = (order + 1).astype(np.int64)
    cuts = np.where(np.arange(max_cuts)[None, :] < (n_parts - 1)[:, None],
                    cuts, hi[:, None])
    cuts.sort(axis=1)
    ends = np.full((n, width), 0, np.int64)
    ends[:, :max_cuts] = cuts
    ends[:, max_cuts:] = hi[:, None]
    return ends.astype(np.int32)


def _balls_into_bins(rng, n_balls, n_bins, width):
    """Row i drops ``n_balls[i]`` balls uniformly into its first
    ``n_bins[i]`` bins; returns the counts (n, width)."""
    n = len(n_balls)
    m = int(n_balls.max()) if n else 0
    if n == 0 or m == 0:
        return np.zeros((n, width), np.int64)
    bins = rng.integers(0, np.maximum(n_bins, 1)[:, None], size=(n, m))
    live = np.arange(m)[None, :] < n_balls[:, None]
    flat = (np.arange(n)[:, None] * width + bins)[live]
    return np.bincount(flat, minlength=n * width).reshape(n, width)


def sample_mixed(rng, n_layers: int, n: int, min_ces: int = 2,
                 max_ces: int = 11, max_segments: int = 6):
    """Each segment independently single-CE or pipelined."""
    if not 1 <= min_ces <= max_ces <= NC:
        raise ValueError(f"need 1 <= min_ces <= max_ces <= {NC}")
    total = rng.integers(min_ces, max_ces + 1, size=n)
    cap = np.minimum(np.minimum(max_segments, total), min(n_layers, NS))
    n_seg = rng.integers(1, cap + 1)
    seg_end = _rand_partitions(rng, np.full(n, n_layers, np.int64), n_seg, NS)
    alloc = 1 + _balls_into_bins(rng, total - n_seg, n_seg, NS)
    active = np.arange(NS)[None, :] < n_seg[:, None]
    seg_nce = np.where(active, alloc, 1).astype(np.int32)
    seg_pipe = active & (seg_nce > 1)
    inter = (n_seg > 1) & (rng.integers(0, 2, size=n) > 0)
    return seg_end, seg_pipe, seg_nce, inter


FAMILIES = {"mixed": sample_mixed}


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's draws: the same seed gives
    the same draws, and each stream (designs, sampled rows) its own."""
    return np.random.default_rng([seed % 2**63, stream])


def design_pool(mix: dict, n_layers: int, seed: int) -> list[tuple]:
    """The mix's ``pool_batches`` batches of ``designs_per_call`` designs,
    each (seg_end, seg_pipe, seg_nce, inter_pipe) host arrays."""
    sample = FAMILIES[mix["family"]]
    rng = seed_rng(seed, 0)
    return [sample(rng, n_layers, mix["designs_per_call"],
                   **mix.get("family_args", {}))
            for _ in range(mix["pool_batches"])]

