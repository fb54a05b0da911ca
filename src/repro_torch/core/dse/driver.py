"""End-to-end DSE drivers: random sampling and guided search behind one
``Session.explore()`` call (paper §V-E, use case 3).

``_explore(net, dev, n, strategy="random")`` reproduces the paper's blind
100k-sample sweep with the vectorized samplers; ``strategy="search"``
spends the same evaluation budget on the guided evolutionary loop and
returns the persistent Pareto archive as the front.  Both report the
whole evaluated sample so benchmarks can compare fronts side by side.

The port of the JAX package's ``core/dse/driver.py``.  The designs are
drawn on the host, as there, and scored by the batch path on the device
of the tables (the card unless the caller asks for the CPU).  The
deprecated ``explore`` shim is not ported: ``Session.explore`` is the
entry point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..device import DeviceSpec
from .encoding import DesignBatch, concat_batches
from .pareto import dominates_matrix, pareto
from .samplers import sample_custom, sample_mixed
from .search import SearchConfig, SearchResult, orient, search

DEFAULT_OBJECTIVES = ("latency_s", "buffer_bytes")


@dataclass
class DSEResult:
    batch: DesignBatch                # every evaluated design, on the host
    metrics: dict[str, np.ndarray]
    seconds: float
    per_design_us: float
    strategy: str = "random"
    n_evals: int = 0
    objectives: tuple[str, ...] = DEFAULT_OBJECTIVES
    front: np.ndarray = field(default_factory=lambda: np.empty(0, np.intp))
    #: per generation (search) or chunk (random): host seconds drawing
    #: designs (``breed_s``) and seconds of the device work with its pulls
    #: (``step_s``)
    timings: list[dict] = field(default_factory=list)
    #: the search's per-generation archive record (empty for random)
    history: list[dict] = field(default_factory=list)
    #: the island search's per-island front indices into ``batch`` (empty
    #: for one population and for random)
    island_fronts: list = field(default_factory=list)
    #: schedule-refined front metrics, front-aligned arrays: set only by
    #: ``Session.explore(refine="schedule")``
    refined: dict | None = None

    def front_points(self) -> np.ndarray:
        """Oriented (lower-better) objective points of the front rows."""
        return orient(self.metrics, self.objectives)[self.front]


def _explore(net, dev, n: int = 100_000, *,
             family: str = "custom", seed: int = 0, chunk: int = 4096,
             strategy: str = "random",
             objectives: tuple[str, ...] = DEFAULT_OBJECTIVES,
             config: SearchConfig | None = None, tables,
             tile: int | None = None,
             eval_chunk: int | None = None, mesh=None) -> DSEResult:
    """Implementation behind ``Session.explore``: evaluate ``n`` designs
    and return the sample plus its Pareto front.

    strategy="random": sample ``family`` ("custom" | "mixed" | "both") and
    evaluate, exactly the paper's use case;  strategy="search": run the
    guided multi-objective loop at the same evaluation budget, with
    ``family`` seeding the initial population/immigrants.  ``chunk``
    applies to the random strategy only (designs drawn and scored at a
    time) -- the search equivalent is ``config.pop_size``.

    A ``config``, when given, is authoritative for the search (only the
    budget comes from ``n``); the ``seed``/``objectives``/``family``
    keywords configure the search only when no config is passed.
    ``tables`` (the net's ``NetTables``) pick the device.  ``tile`` and
    ``eval_chunk`` are the batch path's blocks on the CPU and on the card
    (None: its defaults).  ``mesh`` (a ``core.shard.EvalMesh``) shards the
    random sweep's design axis and turns the search into the island model;
    None keeps the single-device paths bit-identical.
    """
    from ..batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, _pad_rows,
                              evaluate_batch, make_device_tables)

    tile, eval_chunk = tile or DEFAULT_TILE, eval_chunk or DEFAULT_CHUNK
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if strategy == "search":
        if config is not None:
            cfg = SearchConfig(**{**config.__dict__, "budget": n})
        else:
            cfg = SearchConfig(budget=n, seed=seed,
                               objectives=tuple(objectives),
                               init_family=family)
        objectives = cfg.objectives
        res: SearchResult = search(net, dev, cfg, tables=tables, tile=tile,
                                   chunk=eval_chunk, mesh=mesh)
        return DSEResult(
            batch=res.batch, metrics=res.metrics, seconds=res.seconds,
            per_design_us=res.seconds / max(res.n_evals, 1) * 1e6,
            strategy="search", n_evals=res.n_evals,
            objectives=tuple(objectives), front=res.front_idx,
            timings=res.timings, history=res.history,
            island_fronts=res.island_fronts)
    if strategy != "random":
        raise ValueError(f"unknown strategy {strategy!r}")

    def sampler(rng, n_layers, b):
        if family == "custom":
            return sample_custom(rng, n_layers, b)
        if family == "mixed":
            return sample_mixed(rng, n_layers, b)
        if family == "both":
            half = b // 2
            return concat_batches([sample_custom(rng, n_layers, half),
                                   sample_mixed(rng, n_layers, b - half)])
        raise ValueError(f"unknown family {family!r}")

    device = tables.device
    devt = make_device_tables(dev, device=device) \
        if isinstance(dev, DeviceSpec) else dev
    rng = np.random.default_rng(seed)
    n_layers = tables.L
    outs: list[dict] = []
    batches: list[DesignBatch] = []
    timings: list[dict] = []
    t0 = time.time()
    done = 0
    while done < n:
        b = min(chunk, n - done)
        t_draw = time.perf_counter()
        batch = sampler(rng, n_layers, b)
        t_eval = time.perf_counter()
        # pad the tail chunk to the full chunk size: every call scores one
        # shape (padded rows are sliced off below); the pulls wait for the
        # device, so the clock stops on finished work
        out = evaluate_batch(_pad_rows(batch.to(device), min(chunk, n)),
                             tables, devt, tile=tile, chunk=eval_chunk,
                             mesh=mesh)
        outs.append({k: v[:b].cpu().numpy() for k, v in out.items()})
        batches.append(batch)
        timings.append(dict(chunk=len(timings), breed_s=t_eval - t_draw,
                            step_s=time.perf_counter() - t_eval))
        done += b
    dt = time.time() - t0
    merged = concat_batches(batches)
    metrics = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    front = pareto(orient(metrics, objectives))
    return DSEResult(batch=merged, metrics=metrics, seconds=dt,
                     per_design_us=dt / n * 1e6, strategy="random",
                     n_evals=n, objectives=tuple(objectives), front=front,
                     timings=timings)


def best_scalar_index(metrics: dict[str, np.ndarray],
                      objectives: tuple[str, ...] = DEFAULT_OBJECTIVES,
                      weights=None) -> int:
    """Index of the best design under normalized weighted scalarization --
    the single 'best sample' a random sweep would report."""
    pts = orient(metrics, objectives)
    lo, hi = pts.min(0), pts.max(0)
    norm = (pts - lo) / np.maximum(hi - lo, 1e-30)
    w = np.ones(pts.shape[1]) if weights is None else np.asarray(weights)
    return int(np.argmin(norm @ (w / w.sum())))


def dominating_indices(points: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Indices of rows that strictly dominate ``ref`` (all <=, any <)."""
    points = np.asarray(points, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.nonzero(dominates_matrix(points, ref[None, :])[:, 0])[0]
