"""Non-dominated fronts, vectorized (host numpy).

The port's own copy of the JAX package's ``core/dse/pareto.py``: the same
functions, the same 1e-12 slack and keep-first-duplicate convention, so
both packages pick the same front from the same points.

``pareto`` replaces the seed's quadratic Python scan: the 2-D case (the
common (latency, buffer) / (-throughput, buffer) fronts) is a lexsort +
running-min — O(N log N) and bit-identical to the seed implementation,
including its 1e-12 slack and keep-first-duplicate convention.  Higher
dimensions use the standard iterative strict-domination filter whose inner
step is one broadcast compare (near-linear passes when the front is small,
as it is for DSE metric sets).

``ParetoArchive`` is the incremental variant the guided search loop uses:
each update refronts the (small) archived front together with the incoming
batch — one ``pareto()`` pass over archive+batch instead of over the whole
history, which keeps the archive exactly equal to ``pareto()`` of
everything seen (pairwise screening only approximates the EPS slack and
keep-first-duplicate conventions).
"""
from __future__ import annotations

import numpy as np

EPS = 1e-12


def _front_2d(points: np.ndarray) -> np.ndarray:
    order = np.lexsort((points[:, 1], points[:, 0]))
    y = points[order, 1]
    prev_min = np.concatenate(([np.inf], np.minimum.accumulate(y)[:-1]))
    keep = y < prev_min - EPS
    keep[0] = True
    return np.sort(order[keep])


def _front_nd(points: np.ndarray) -> np.ndarray:
    # lexsort first: guarantees keep-first among duplicates and that no
    # earlier point is strictly dominated by a later one
    order = np.lexsort(points.T[::-1])
    pts = points[order]
    alive = order.copy()
    i = 0
    while i < len(pts):
        nd = np.any(pts < pts[i], axis=1)   # survives iff not (weakly)
        nd[i] = True                        # dominated by pts[i]
        alive, pts = alive[nd], pts[nd]
        i = int(nd[:i].sum()) + 1
    return np.sort(alive)


def pareto(points: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated front.  ``points`` (N, M): every metric
    oriented so LOWER is better.  Duplicates keep one representative."""
    points = np.asarray(points, np.float64)
    if points.ndim != 2:
        raise ValueError(f"points must be (N, M), got {points.shape}")
    if len(points) == 0:
        return np.empty((0,), np.intp)
    if points.shape[1] == 2:
        return _front_2d(points)
    return _front_nd(points)


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Dominated hypervolume of a 2-D lower-is-better point set w.r.t. a
    reference (upper-bound) point — the scalar the multinet benchmarks use
    to compare searched fronts against baseline fronts.

    Points at or beyond ``ref`` in either coordinate contribute nothing.
    """
    points = np.asarray(points, np.float64)
    ref = np.asarray(ref, np.float64)
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be (N, 2), got {points.shape}")
    inside = (points < ref[None, :]).all(1)
    points = points[inside]
    if len(points) == 0:
        return 0.0
    front = points[pareto(points)]
    order = np.argsort(front[:, 0], kind="stable")
    x, y = front[order, 0], front[order, 1]
    # ascending x => strictly descending y on a clean front; guard ties
    y = np.minimum.accumulate(y)
    prev_y = np.concatenate(([ref[1]], y[:-1]))
    return float(((ref[0] - x) * (prev_y - y)).sum())


def knee_point(points: np.ndarray) -> np.ndarray:
    """The span-normalized best-sum point of an oriented (lower-better)
    point set — the single 'knee' the multinet benchmarks and examples
    report from a front."""
    points = np.asarray(points, np.float64)
    span = np.maximum(np.ptp(points, 0), 1e-30)
    return points[np.argmin(((points - points.min(0)) / span).sum(1))]


def dominates_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) bool: a[i] dominates b[j] (all <=, any <)."""
    le = (a[:, None, :] <= b[None, :, :]).all(-1)
    lt = (a[:, None, :] < b[None, :, :]).any(-1)
    return le & lt


class ParetoArchive:
    """Persistent non-dominated archive over lower-is-better points.

    ``update`` screens a batch of candidates against the current front and
    returns the mask of candidates that entered; each archived point
    carries an integer payload (e.g. a global design index) so callers can
    recover the designs behind the front.
    """

    def __init__(self, n_obj: int):
        self.points = np.empty((0, n_obj), np.float64)
        self.payload = np.empty((0,), np.int64)

    def __len__(self) -> int:
        return len(self.points)

    def update(self, points: np.ndarray, payload: np.ndarray) -> np.ndarray:
        points = np.asarray(points, np.float64)
        payload = np.asarray(payload, np.int64)
        if len(points) == 0:
            return np.zeros((0,), bool)
        # refront the (small) archive + the incoming batch in one pass so
        # the archive is ``pareto()`` of everything seen, by construction
        # (including its 1e-12 slack / keep-first-duplicate conventions —
        # pairwise screening replicated those only approximately)
        n_arch = len(self.points)
        combined = np.concatenate([self.points, points])
        keep = pareto(combined)
        self.points = combined[keep]
        self.payload = np.concatenate([self.payload, payload])[keep]
        entered = np.zeros(len(points), bool)
        entered[keep[keep >= n_arch] - n_arch] = True
        return entered
