"""End-to-end multinet driver: one ``Session.deploy()`` call per arm.

Five strategies at one evaluation budget (deployments evaluated):

* ``"search"``      -- joint DSE: per-model designs AND the spatial budget
                      split evolve together (the headline spatial arm);
* ``"equal_split"`` -- the same search with the split frozen to 1/M: the
  ablation isolating what partition-awareness buys;
* ``"temporal"``    -- time-multiplexed baseline: full-board designs and
  round-robin time shares evolve, no spatial split;
* ``"hybrid"``      -- the general deployment space: designs, splits, time
  shares AND the per-model spatial/shared assignment evolve together;
* ``"random"``      -- blind sampling of designs + Dirichlet splits.

Every guided arm accepts ``objective="slo"`` to drive the front by graded
SLO attainment under per-model deadline distributions.

The port of the JAX package's ``core/multinet/driver.py``: designs and
shares are drawn on the host from one seed, as there, and scored by
:func:`joint_evaluate` on the tables' device.  The deprecated
``joint_explore`` shim is not ported: ``Session.deploy`` is the entry
point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..dse.encoding import MultiDesignBatch, stack_designs
from ..dse.pareto import hypervolume_2d, pareto
from ..dse.samplers import sample_mixed
from ..dse.search import orient
from .joint_eval import joint_evaluate, make_multi_tables
from .partition import sample_shares
from .search import (JOINT_OBJECTIVES, MultinetSearchConfig,
                     MultinetSearchResult, _KEEP_MODE, _KEEP_SYS,
                     joint_search)


@dataclass
class JointDSEResult:
    """One arm's outcome: every evaluated deployment (designs on the host
    + raw gene values in ``shares``), the kept system metrics, and the
    Pareto ``front`` indices over the arm's oriented ``objectives``."""

    designs: MultiDesignBatch
    metrics: dict[str, np.ndarray]
    seconds: float
    per_eval_us: float
    strategy: str = "search"
    mode: str = "spatial"
    n_evals: int = 0
    n_models: int = 0
    objectives: tuple[str, ...] = JOINT_OBJECTIVES
    front: np.ndarray = field(default_factory=lambda: np.empty(0, np.intp))
    #: raw share genomes per resource, one row per evaluated deployment:
    #: re-feeding row i to ``joint_evaluate`` reproduces its metrics
    shares: dict[str, np.ndarray] = field(default_factory=dict)
    #: per generation (guided arms) or chunk (random): host seconds
    #: breeding or drawing (``breed_s``) and seconds of the joint
    #: evaluation with its pulls (``step_s``)
    timings: list[dict] = field(default_factory=list)

    def front_points(self) -> np.ndarray:
        """Oriented (lower-better) objective points of the front rows."""
        return orient(self.metrics, self.objectives)[self.front]

    def hypervolume(self, ref: np.ndarray) -> float:
        """Dominated 2-D hypervolume of the front w.r.t. ``ref`` (a point
        weakly dominated by every front point)."""
        return hypervolume_2d(self.front_points(), ref)


def _joint_explore(nets, dev, n: int = 4096, *, strategy: str = "search",
                   seed: int = 0, chunk: int = 512,
                   objectives: tuple[str, ...] = JOINT_OBJECTIVES,
                   objective: str = "serving",
                   config: MultinetSearchConfig | None = None,
                   weights=None, slo_s=None, mtables=None, device="cuda",
                   tile: int | None = None,
                   eval_chunk: int | None = None,
                   mesh=None) -> JointDSEResult:
    """Implementation behind ``Session.deploy``: evaluate ``n``
    deployments of ``nets`` on ``dev`` and return the sample plus its
    Pareto front over the system objectives.

    A ``config``, when given, is authoritative for the guided arms (only
    the budget comes from ``n``; the strategy still selects the mode and
    the freeze).  ``objective="slo"`` (when ``config`` is None) swaps the
    front driver to graded deadline attainment.  Caller-provided
    ``mtables`` are used verbatim by EVERY strategy, random included, and
    pick the device; else the tables are built on ``device``.  ``tile``
    and ``eval_chunk`` are the batch path's blocks on the CPU and on the
    card (None: the defaults).  A sharded ``mesh`` (``core.shard.EvalMesh``)
    shards every ``joint_evaluate`` call's deployment axis.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    m = len(nets)
    blocks = {k: v for k, v in (("tile", tile), ("chunk", eval_chunk))
              if v is not None}
    if strategy in ("search", "equal_split", "temporal", "hybrid"):
        base = config.__dict__ if config is not None else {}
        over = dict(budget=n,
                    mode={"temporal": "temporal",
                          "hybrid": "hybrid"}.get(strategy, "spatial"),
                    freeze_partition=strategy == "equal_split")
        if config is None:
            over.update(seed=seed, objectives=tuple(objectives),
                        objective=objective, weights=weights, slo_s=slo_s)
        cfg = MultinetSearchConfig(**{**base, **over})
        res: MultinetSearchResult = joint_search(
            nets, dev, cfg, mtables=mtables, device=device, mesh=mesh,
            **blocks)
        return JointDSEResult(
            designs=res.designs, metrics=res.metrics, seconds=res.seconds,
            per_eval_us=res.seconds / max(res.n_evals, 1) * 1e6,
            strategy=strategy, mode=res.mode, n_evals=res.n_evals,
            n_models=m, objectives=res.objectives, front=res.front_idx,
            shares=res.shares, timings=res.timings)
    if strategy != "random":
        raise ValueError(f"unknown strategy {strategy!r}")

    rng = np.random.default_rng(seed)
    mt = mtables if mtables is not None else make_multi_tables(
        nets, weights=weights, slo_s=slo_s, device=device)
    max_m = mt.max_m
    keep = _KEEP_SYS + _KEEP_MODE["spatial"]
    outs, mds, timings = [], [], []
    shares = {r: [] for r in ("pes", "buf", "bw")}
    t0 = time.time()
    done = 0
    while done < n:
        b = min(chunk, n - done)
        t_draw = time.perf_counter()
        md = stack_designs([sample_mixed(rng, len(net), b, min_ces=1)
                            for net in nets], max_m)
        sh = [sample_shares(rng, b, max_m, m) for _ in range(3)]
        for r, s in zip(shares, sh):
            shares[r].append(s)
        mds.append(md)
        if b < chunk:   # pad the tail chunk: every call is one shape
            pad = np.concatenate([np.arange(b),
                                  np.full(chunk - b, b - 1)])
            md = md.take(pad)
            sh = [s[pad] for s in sh]
        t_eval = time.perf_counter()
        out = joint_evaluate(md, mt, dev, pes_shares=sh[0],
                             buf_shares=sh[1], bw_shares=sh[2], mesh=mesh,
                             **blocks)
        outs.append({k: out[k][:b].cpu().numpy() for k in keep})
        timings.append(dict(chunk=len(timings), breed_s=t_eval - t_draw,
                            step_s=time.perf_counter() - t_eval))
        done += b
    dt = time.time() - t0
    designs = MultiDesignBatch.from_numpy(*(
        np.concatenate(parts) for parts in zip(*(d.to_numpy()
                                                 for d in mds))))
    metrics = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    front = pareto(orient(metrics, objectives))
    return JointDSEResult(designs=designs, metrics=metrics, seconds=dt,
                          per_eval_us=dt / n * 1e6, strategy="random",
                          n_evals=n, n_models=m,
                          objectives=tuple(objectives), front=front,
                          shares={r: np.concatenate(v)
                                  for r, v in shares.items()},
                          timings=timings)
