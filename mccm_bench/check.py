"""The comparison that decides ``correct``.

Every call of the window hands back all of its designs' metrics; a sample
of rows of each call, drawn from the seed, is kept, and once the window
has closed the plain reference (``reference.py``) evaluates those designs
again from the configuration and the same host arrays.  The number
compared is the widest relative gap over every kept row and metric:
|program - reference| / max(|reference|, median |reference| of that
metric), so that a metric near 0 on one row is judged against its usual
size.  ``n_ces`` is compared the same way, so a CE miscounted reads as a
gap of at least 1/16.

``LIMITS`` holds each number's limit; ``PERF.md`` gives the readings of
the program and of the bfloat16 control they were set from.
"""
from __future__ import annotations

import numpy as np

METRICS = ("latency_s", "throughput_ips", "buffer_bytes",
           "buffer_alloc_bytes", "access_bytes", "weight_access_bytes",
           "fm_access_bytes", "utilization", "n_ces")

#: each compared number's limit: the widest relative gap, and the calls
#: that raised or handed back a missing, misshapen or non-finite metric
LIMITS = {"max_rel_gap": 1e-4, "failed_calls": 0}


def sample_rows(rng, n: int, k: int) -> np.ndarray:
    """``k`` rows of an ``n``-design call, drawn with replacement."""
    return rng.integers(0, n, size=k)


def reference_rows(records, pool, ref) -> dict:
    """The reference's metrics of every kept row: for each pool batch, its
    distinct kept rows and their metrics."""
    rows = {}
    for k, r, _ in records:
        rows.setdefault(k, []).append(r)
    out = {}
    for k, rs in rows.items():
        uniq = np.unique(np.concatenate(rs))
        out[k] = (uniq, ref.evaluate(tuple(a[uniq] for a in pool[k])))
    return out


def widest_gap(records, want: dict) -> tuple[float, dict]:
    """The widest relative gap of the kept rows ``records`` (pool index,
    rows, metrics) from ``want`` (``reference_rows``), and where it is."""
    scale = {m: float(np.median(np.abs(np.concatenate(
        [v[m] for _, v in want.values()]).astype(np.float64))))
        for m in METRICS}
    worst, where = 0.0, {}
    for k, rows, got in records:
        uniq, ref = want[k]
        idx = np.searchsorted(uniq, rows)
        for m in METRICS:
            w = ref[m][idx].astype(np.float64)
            g = np.asarray(got[m], np.float64)
            gap = np.abs(g - w) / np.maximum(np.abs(w), scale[m])
            gap = np.where(np.isnan(gap), np.inf, gap)
            i = int(np.argmax(gap))
            if gap[i] > worst or not where:
                worst = float(gap[i])
                where = {"metric": m, "batch": int(k), "row": int(rows[i]),
                         "program": float(g[i]), "reference": float(w[i])}
    return worst, where


def replay(records, got: dict) -> list:
    """The kept rows ``records`` with their metrics taken from ``got``
    (``reference_rows`` of another evaluator): that evaluator put in the
    program's place."""
    out = []
    for k, rows, _ in records:
        uniq, vals = got[k]
        idx = np.searchsorted(uniq, rows)
        out.append((k, rows, {m: vals[m][idx] for m in METRICS}))
    return out


def verdict(readings: dict) -> bool:
    """Every compared number within its limit."""
    return all(readings[k] <= lim for k, lim in LIMITS.items())
