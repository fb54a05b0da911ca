"""Joint DSE over (per-model budget split × per-model CE arrangement ×
spatial/temporal deployment assignment).

The multinet genome extends the single-model one: each deployment row is M
``DesignBatch`` planes (bred per model with the single-model
``make_children`` operators, so every segment/CE/pipeline mutation carries
over) plus raw resource shares (spatial: DSP/BRAM/bandwidth; temporal:
round-robin time slices; hybrid: both) and, in hybrid mode, the per-model
**assignment** gene (dedicated spatial slice vs membership in the shared
time-multiplexed slice).  Share variation adds two operators of its own:

* share mutation          -- one model's share scaled by a lognormal factor;
* transfer-of-budget      -- crossover takes parent A's deployment and
  re-allocates budget model-wise from parent B, plus an explicit
  move-δ-from-model-i-to-j mutation.

Assignment variation adds three more (hybrid mode):

* assignment flip         -- one model's spatial/shared bit toggled;
* slice merge / split     -- a dedicated model folded INTO the shared slice,
  or a member pulled OUT into its own slice;
* assignment crossover    -- child keeps parent A's assignment but adopts
  parent B's choice on a random model subset.

Raw genes are repaired inside the joint evaluator, on the device
(``repair_partition_torch`` / ``slice_masks``), so breeding never has to
keep deployments feasible.  Selection keeps a :class:`ParetoArchive` over
the oriented system objectives: the default ``objective="serving"`` front
is (worst-model latency, max-min weighted throughput); ``objective="slo"``
drives the front by graded SLO attainment under per-model deadline
distributions (``slo_attainment_dist``, paired with aggregate throughput).

The equal-split baseline arm is the SAME search with
``freeze_partition=True`` (shares pinned to 1/M): identical budget,
operators and seeds.

The port of the JAX package's ``core/multinet/search.py``.  Breeding is
host numpy on ``np.random.default_rng``, operator for operator the JAX
package's (a copy of its code), so from one seed both packages draw the
same designs, shares and assignments; each generation's deployments are
evaluated by :func:`joint_evaluate` on the tables' device (one batch-path
call per model lane, one search-kernel launch per lane and chunk on the
card) and only the kept metrics are pulled to the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .. import resilience
from ..dse.encoding import (NS, DesignBatch, MultiDesignBatch,
                            concat_batches, sample_assign, stack_designs)
from ..dse.pareto import ParetoArchive
from ..dse.samplers import sample_mixed
from ..dse.search import (SearchConfig, _checkpoint_meta, _gen_telemetry,
                          _load_search_checkpoint, _merged_metrics,
                          make_children, orient)
from .joint_eval import (DEADLINE_SCALES, joint_evaluate, make_multi_tables,
                         slo_attainment_dist)
from .partition import (DEFAULT_FLOORS, DEFAULT_MAX_M, equal_shares,
                        sample_shares)

#: default joint objectives: the multi-tenant serving trade-off -- the
#: worst co-resident model's latency vs the max-min (weighted) model
#: throughput.  Aggregate throughput stays reported but is not the default
#: objective: it rewards starving the expensive model.
JOINT_OBJECTIVES = ("worst_latency_s", "min_model_throughput_ips")

#: objectives of ``objective="slo"``: graded deadline attainment traded
#: against aggregate throughput
SLO_OBJECTIVES = ("slo_attainment_dist", "agg_throughput_ips")

#: metric keys kept for every evaluated deployment (system metrics plus
#: the repaired splits, so fronts decode straight to deployments)
_KEEP_SYS = ("agg_throughput_ips", "worst_latency_s",
             "min_model_throughput_ips", "fairness",
             "slo_attainment", "traffic_bytes_per_s",
             "per_model_latency_s", "per_model_throughput_ips",
             "per_model_access_bytes")
_KEEP_MODE = {"spatial": ("pes_split", "buf_split", "bw_split"),
              "temporal": ("time_share", "round_period_s"),
              "hybrid": ("pes_split", "buf_split", "bw_split",
                         "time_share", "round_period_s", "assign")}


@dataclass
class MultinetSearchConfig:
    """Knobs of the joint deployment search (see module docstring).

    ``mode`` picks the co-execution space (spatial splits, temporal
    round-robin, or the hybrid assignment space containing both);
    ``objective`` picks what drives the Pareto front: ``"serving"`` keeps
    the ``objectives`` tuple as given (default: worst-model latency vs
    max-min throughput), ``"slo"`` swaps an untouched default for
    ``SLO_OBJECTIVES`` and requires per-model SLOs (``slo_s`` here or on
    the supplied tables).  ``deadline_scales`` is the per-model deadline
    distribution grid of the graded attainment metric."""

    pop_size: int = 512
    budget: int = 4096                # total deployment evaluations
    objectives: tuple[str, ...] = JOINT_OBJECTIVES
    mode: str = "spatial"             # "spatial" | "temporal" | "hybrid"
    objective: str = "serving"        # "serving" | "slo"
    deadline_scales: tuple[float, ...] = DEADLINE_SCALES
    freeze_partition: bool = False    # pin shares to the equal split
    min_ces: int = 1                  # per-model CE bounds
    max_ces: int = 11
    seed: int = 0
    # per-model design variation (forwarded to dse.make_children)
    crossover_frac: float = 0.5
    shift_frac: float = 0.6
    split_frac: float = 0.15
    merge_frac: float = 0.15
    nce_frac: float = 0.4
    flip_frac: float = 0.15
    inter_frac: float = 0.1
    # share variation
    share_mutate_frac: float = 0.5
    share_sigma: float = 0.35
    transfer_frac: float = 0.4
    transfer_delta: float = 0.5
    share_crossover_frac: float = 0.5
    # assignment variation (hybrid mode).  The assignment gene is only M
    # bits, so it evolves on a slower timescale than shares/designs
    assign_flip_frac: float = 0.08
    merge_split_frac: float = 0.15
    assign_crossover_frac: float = 0.25
    p_shared_init: float = 0.35       # shared-membership rate of fresh rows
    reconfig_s: float = 0.0           # per-round partial-reconfig charge
    #: trailing fraction of generations run memetically: children inherit a
    #: front parent's split (small jitter only)
    exploit_frac: float = 0.4
    immigrant_frac: float = 0.15
    elite_frac: float = 0.25
    weights: tuple[float, ...] | None = None   # per-model request weights
    slo_s: tuple[float, ...] | None = None
    floors: tuple[float, float, float] = DEFAULT_FLOORS
    max_m: int = DEFAULT_MAX_M
    # ---- checkpoint/resume (a resumed run is bit-identical) ------------
    checkpoint_path: str | None = None
    checkpoint_interval: int = 8
    resume: bool = False

    def design_cfg(self) -> SearchConfig:
        """The per-model design-operator knobs, as the single-model
        SearchConfig that ``dse.make_children`` consumes."""
        return SearchConfig(
            min_ces=self.min_ces, max_ces=self.max_ces,
            crossover_frac=self.crossover_frac, shift_frac=self.shift_frac,
            split_frac=self.split_frac, merge_frac=self.merge_frac,
            nce_frac=self.nce_frac, flip_frac=self.flip_frac,
            inter_frac=self.inter_frac)


@dataclass
class MultinetSearchResult:
    """Everything :func:`joint_search` evaluated, in evaluation order:
    design planes (on the host), raw gene values (``shares`` also carries
    the ``"assign"`` genome in hybrid mode), kept metrics, the oriented
    objective points and the Pareto-front indices into all of them."""

    designs: MultiDesignBatch         # every evaluated deployment, in order
    shares: dict[str, np.ndarray]     # raw share genomes per resource
    metrics: dict[str, np.ndarray]    # system metrics + repaired splits
    points: np.ndarray                # (n_evals, n_obj) oriented objectives
    front_idx: np.ndarray
    objectives: tuple[str, ...]
    mode: str
    n_evals: int
    seconds: float
    history: list[dict] = field(default_factory=list)
    #: per generation: host seconds breeding the next population
    #: (``breed_s``, 0 for the last) and seconds of the joint evaluation
    #: with its pulls (``step_s``)
    timings: list[dict] = field(default_factory=list)

    def front_points(self) -> np.ndarray:
        """Oriented (lower-better) objective points of the front rows."""
        return self.points[self.front_idx]


# --------------------------------------------------------------------------
# share variation operators (host numpy, raw positive genomes)
# --------------------------------------------------------------------------
def _mutate_shares(rng, shares, m, frac, sigma):
    """One random model's share scaled by lognormal(sigma), per row w.p.
    ``frac``.  Operates in place on the (n, max_m) raw genome."""
    n = len(shares)
    do = rng.random(n) < frac
    col = rng.integers(0, m, size=n)
    factor = np.exp(rng.normal(0.0, sigma, size=n)).astype(np.float32)
    rows = np.nonzero(do)[0]
    shares[rows, col[rows]] *= factor[rows]


def _transfer_budget(rng, shares, m, frac, delta):
    """Move ``delta`` of model i's share to model j (i != j), per row w.p.
    ``frac`` — the explicit budget-transfer mutation."""
    if m < 2:
        return
    n = len(shares)
    do = rng.random(n) < frac
    i = rng.integers(0, m, size=n)
    j = (i + rng.integers(1, m, size=n)) % m
    rows = np.nonzero(do)[0]
    moved = delta * shares[rows, i[rows]]
    shares[rows, i[rows]] -= moved
    shares[rows, j[rows]] += moved


def _crossover_shares(rng, a, b, m, frac):
    """Transfer-of-budget crossover: child keeps parent A's shares but,
    per row w.p. ``frac``, adopts parent B's allocation on a random
    nonempty model subset — budget moves between models exactly as the two
    parents disagreed."""
    n, max_m = a.shape
    take_b = rng.random((n, max_m)) < 0.5
    take_b[:, m:] = False
    none = ~take_b[:, :m].any(1)
    take_b[none, rng.integers(0, m, size=int(none.sum()))] = True
    do = (rng.random(n) < frac)[:, None]
    return np.where(do & take_b, b, a)


def _breed_shares(rng, pool_shares, pa, pb, m, cfg) -> np.ndarray:
    child = _crossover_shares(rng, pool_shares[pa].copy(),
                              pool_shares[pb], m,
                              cfg.share_crossover_frac)
    _transfer_budget(rng, child, m, cfg.transfer_frac, cfg.transfer_delta)
    _mutate_shares(rng, child, m, cfg.share_mutate_frac, cfg.share_sigma)
    return np.maximum(child, 1e-6 * child.max(initial=1.0))


# --------------------------------------------------------------------------
# assignment operators (hybrid mode; (n, max_m) 0/1 genomes, in place)
# --------------------------------------------------------------------------
def _flip_assign(rng, assign, m, frac):
    """Assignment-flip mutation: one random model's spatial/shared bit
    toggled, per row w.p. ``frac``."""
    n = len(assign)
    do = rng.random(n) < frac
    col = rng.integers(0, m, size=n)
    rows = np.nonzero(do)[0]
    assign[rows, col[rows]] = 1.0 - (assign[rows, col[rows]] > 0.5)


def _merge_split_assign(rng, assign, m, frac):
    """Slice merge/split mutation: per row w.p. ``frac``, either *merge* a
    random dedicated model into the shared slice or *split* a random
    member out into its own slice — directed flips, so the slice structure
    changes even when a uniform flip would pick an empty side."""
    if m < 2:
        return
    n = len(assign)
    do = rng.random(n) < frac
    merge = rng.random(n) < 0.5
    memb = assign[:, :m] > 0.5
    # pick a random column on the chosen side; rows whose chosen side is
    # empty (nothing to merge/split) are skipped
    side = np.where(merge[:, None], ~memb, memb)
    keys = np.where(side, rng.random((n, m)), -1.0)
    col = np.argmax(keys, axis=1)
    ok = do & side.any(1)
    rows = np.nonzero(ok)[0]
    assign[rows, col[rows]] = merge[rows].astype(np.float32)


def _crossover_assign(rng, a, b, m, frac):
    """Slice-merge/split crossover: child keeps parent A's assignment but,
    per row w.p. ``frac``, adopts parent B's spatial/shared choice on a
    random nonempty model subset — the shared slice merges or splits
    exactly where the parents disagreed."""
    n, max_m = a.shape
    take_b = rng.random((n, max_m)) < 0.5
    take_b[:, m:] = False
    none = ~take_b[:, :m].any(1)
    take_b[none, rng.integers(0, m, size=int(none.sum()))] = True
    do = (rng.random(n) < frac)[:, None]
    return np.where(do & take_b, b, a)


# --------------------------------------------------------------------------
# the search loop
# --------------------------------------------------------------------------
def joint_search(nets, dev, config: MultinetSearchConfig | None = None,
                 mtables=None, *, device="cuda", tile: int | None = None,
                 chunk: int | None = None,
                 mesh=None) -> MultinetSearchResult:
    """Run the joint loop: sample deployments -> joint evaluate -> archive
    -> breed designs, budget splits and (hybrid) assignments together.

    Caller-provided ``mtables`` are used verbatim (and pick the device);
    else the tables are built on ``device``.  ``tile`` and ``chunk`` are
    the batch path's blocks on the CPU and on the card (None: the
    defaults).  A sharded ``mesh`` (``core.shard.EvalMesh``) shards every
    generation's deployment axis across its devices."""
    cfg = config or MultinetSearchConfig()
    if cfg.budget < 1 or cfg.pop_size < 1:
        raise ValueError(f"budget and pop_size must be >= 1 "
                         f"(got {cfg.budget}, {cfg.pop_size})")
    if cfg.mode not in ("spatial", "temporal", "hybrid"):
        raise ValueError(f"unknown mode {cfg.mode!r}; known: spatial, "
                         f"temporal, hybrid")
    if cfg.objective not in ("serving", "slo"):
        raise ValueError(f"unknown objective {cfg.objective!r}; known: "
                         f"serving, slo")
    mt = mtables if mtables is not None else make_multi_tables(
        nets, weights=cfg.weights, slo_s=cfg.slo_s, max_m=cfg.max_m,
        device=device)
    objectives = tuple(cfg.objectives)
    slo_aware = bool(np.isfinite(mt.slo_s.cpu().numpy()).any())
    if cfg.objective == "slo":
        if not slo_aware:
            raise ValueError("objective='slo' needs per-model SLOs: pass "
                             "slo_s on the config or the tables")
        if objectives == JOINT_OBJECTIVES:   # untouched default -> swap
            objectives = SLO_OBJECTIVES
    m = len(nets)
    max_m = mt.max_m
    n_layers = [len(net) for net in nets]
    n_obj = len(objectives)
    rng = np.random.default_rng(cfg.seed)
    dcfg = cfg.design_cfg()
    resources = {"spatial": ("pes", "buf", "bw"), "temporal": ("time",),
                 "hybrid": ("pes", "buf", "bw", "time")}[cfg.mode]
    hybrid = cfg.mode == "hybrid"
    blocks = {k: v for k, v in (("tile", tile), ("chunk", chunk))
              if v is not None}

    pop_n = min(cfg.pop_size, cfg.budget)
    gens = max(1, cfg.budget // pop_n)
    sizes = [pop_n] * gens
    sizes[-1] += cfg.budget - gens * pop_n
    total = cfg.budget

    def fresh_shares(n):
        if cfg.freeze_partition:
            sh = {r: equal_shares(n, max_m, m) for r in resources}
        else:
            sh = {r: sample_shares(rng, n, max_m, m) for r in resources}
            # anchor a few exact equal-split rows so the searched space
            # always contains the baseline deployment
            k = max(1, n // 16)
            for r in resources:
                sh[r][:k] = equal_shares(k, max_m, m)
        if hybrid:
            if cfg.freeze_partition:
                a = np.zeros((n, max_m), np.float32)
            else:
                a = sample_assign(rng, n, max_m, m,
                                  p_shared=cfg.p_shared_init)
                # anchor both pure modes so the hybrid front always
                # contains (and can only improve on) each pure space
                k = max(1, n // 8)
                a[:k] = 0.0
                a[k:2 * k, :m] = 1.0
            sh["assign"] = a
        return sh

    def fresh_designs(n):
        return [sample_mixed(rng, L, n, min_ces=cfg.min_ces,
                             max_ces=cfg.max_ces) for L in n_layers]

    # hall-of-everything buffers (preallocated; written incrementally)
    genes = tuple(resources) + (("assign",) if hybrid else ())
    hall_end = np.empty((total, max_m, NS), np.int32)
    hall_pipe = np.empty((total, max_m, NS), bool)
    hall_nce = np.empty((total, max_m, NS), np.int32)
    hall_inter = np.empty((total, max_m), bool)
    hall_sh = {r: np.empty((total, max_m), np.float32) for r in genes}
    all_points = np.empty((total, n_obj))
    all_metrics: list[dict] = []
    archive = ParetoArchive(n_obj)
    history: list[dict] = []
    timings: list[dict] = []
    keep = _KEEP_SYS + _KEEP_MODE[cfg.mode]

    def eval_gen(md: MultiDesignBatch, sh: dict) -> dict:
        """Evaluate one generation in pop_n-shaped sub-batches (the final
        oversized generation splits; every call is pop_n rows)."""
        n = md.batch
        outs = []
        for s in range(0, n, pop_n):
            idx = np.arange(s, min(s + pop_n, n))
            if len(idx) < pop_n:
                idx_p = np.concatenate([idx, np.repeat(idx[-1:],
                                                       pop_n - len(idx))])
            else:
                idx_p = idx
            sub = md.take(idx_p)
            subsh = {r: v[idx_p] for r, v in sh.items()}
            if cfg.mode == "spatial":
                out = joint_evaluate(sub, mt, dev, pes_shares=subsh["pes"],
                                     buf_shares=subsh["buf"],
                                     bw_shares=subsh["bw"],
                                     floors=cfg.floors, mesh=mesh,
                                     **blocks)
            elif cfg.mode == "temporal":
                out = joint_evaluate(sub, mt, dev, mode="temporal",
                                     time_shares=subsh["time"],
                                     floors=cfg.floors,
                                     reconfig_s=cfg.reconfig_s, mesh=mesh,
                                     **blocks)
            else:
                out = joint_evaluate(sub, mt, dev, mode="hybrid",
                                     assign=subsh["assign"],
                                     pes_shares=subsh["pes"],
                                     buf_shares=subsh["buf"],
                                     bw_shares=subsh["bw"],
                                     time_shares=subsh["time"],
                                     floors=cfg.floors,
                                     reconfig_s=cfg.reconfig_s, mesh=mesh,
                                     **blocks)
            got = {k: out[k][:len(idx)].cpu().numpy() for k in keep}
            if slo_aware:
                got["slo_attainment_dist"] = slo_attainment_dist(
                    got["per_model_latency_s"], mt,
                    scales=cfg.deadline_scales)
            outs.append(got)
        return {k: np.concatenate([o[k] for o in outs])
                if len(outs) > 1 else outs[0][k] for k in outs[0]}

    # ---- checkpoint/resume: restore loop state exactly as it was at
    # the top of generation `start_gen`, before that gen's RNG draws ---
    start_gen, base, elapsed0 = 0, 0, 0.0
    snap = _load_search_checkpoint(cfg, tuple(n_layers), "multinet-search")
    if snap is None:
        pop_md = stack_designs(fresh_designs(sizes[0]), max_m)
        pop_sh = fresh_shares(sizes[0])
    else:
        start_gen, base = snap["gen"], snap["base"]
        rng = resilience.rng_from_state(snap["rng"])
        pop_md = MultiDesignBatch.from_numpy(*snap["pop_md"])
        pop_sh = {r: v.copy() for r, v in snap["pop_sh"].items()}
        hall_end[:base], hall_pipe[:base] = snap["hall"][0], snap["hall"][1]
        hall_nce[:base], hall_inter[:base] = snap["hall"][2], snap["hall"][3]
        for r in genes:
            hall_sh[r][:base] = snap["hall_sh"][r]
        all_points[:base] = snap["points"]
        if snap["metrics"]:
            all_metrics.append(snap["metrics"])
        archive.points = snap["archive"][0].copy()
        archive.payload = snap["archive"][1].copy()
        history.extend(snap["history"])
        elapsed0 = snap["elapsed_s"]
    ckpt_every = max(1, cfg.checkpoint_interval)
    t0 = time.time() - elapsed0
    for gen in range(start_gen, gens):
        if cfg.checkpoint_path and gen > 0 and gen % ckpt_every == 0:
            resilience.save_checkpoint(
                cfg.checkpoint_path, "multinet-search",
                {"gen": gen, "base": base,
                 "rng": resilience.rng_state(rng),
                 "pop_md": tuple(pop_md.to_numpy()),
                 "pop_sh": {r: v.copy() for r, v in pop_sh.items()},
                 "hall": (hall_end[:base].copy(), hall_pipe[:base].copy(),
                          hall_nce[:base].copy(), hall_inter[:base].copy()),
                 "hall_sh": {r: hall_sh[r][:base].copy() for r in genes},
                 "points": all_points[:base].copy(),
                 "metrics": _merged_metrics(all_metrics),
                 "archive": (archive.points.copy(), archive.payload.copy()),
                 "history": list(history),
                 "elapsed_s": time.time() - t0},
                meta=_checkpoint_meta(cfg, tuple(n_layers)))
        t_step = time.perf_counter()
        out = eval_gen(pop_md, pop_sh)
        step_s = time.perf_counter() - t_step
        pts = orient(out, objectives)
        ok = np.isfinite(pts).all(1)
        idx = np.arange(base, base + sizes[gen])
        base += sizes[gen]
        (hall_end[idx], hall_pipe[idx], hall_nce[idx],
         hall_inter[idx]) = pop_md.to_numpy()
        for r in genes:
            hall_sh[r][idx] = pop_sh[r]
        all_points[idx] = pts
        all_metrics.append(out)
        archive.update(pts[ok], idx[ok])

        if gen == gens - 1:
            timings.append(dict(gen=gen, breed_s=0.0, step_s=step_s))
            break

        # ---- parents: archive front + this generation's elite slice ----
        t_breed = time.perf_counter()
        lo, hi = np.nanmin(all_points[:base], 0), np.nanmax(
            np.where(np.isfinite(all_points[:base]), all_points[:base],
                     np.nan), 0)
        norm = (pts - lo) / np.maximum(hi - lo, 1e-30)
        score = np.where(ok, norm.sum(1), np.inf)
        n_elite = max(1, int(sizes[gen] * cfg.elite_frac))
        elite = idx[np.argsort(score, kind="stable")[:n_elite]]
        pool = np.unique(np.concatenate([archive.payload, elite]))
        pool_sh = {r: hall_sh[r][pool] for r in genes}

        n_next = sizes[gen + 1]
        n_imm = int(n_next * cfg.immigrant_frac)
        n_child = n_next - n_imm
        kids = [make_children(
            rng, DesignBatch.from_numpy(
                hall_end[pool][:, mm], hall_pipe[pool][:, mm],
                hall_nce[pool][:, mm], hall_inter[pool][:, mm]),
            n_layers[mm], dcfg, n_child) for mm in range(m)]
        exploit = gen + 1 >= gens - int((gens - 1) * cfg.exploit_frac)
        if cfg.freeze_partition:
            kid_sh = {r: equal_shares(n_child, max_m, m) for r in resources}
            if hybrid:
                kid_sh["assign"] = np.zeros((n_child, max_m), np.float32)
        else:
            pa = rng.integers(0, len(pool), size=n_child)
            pb = rng.integers(0, len(pool), size=n_child)
            if exploit:
                # memetic tail: inherit parent A's split (and assignment)
                # near-verbatim so design breeding refines the deployments
                # the explore phase surfaced
                kid_sh = {}
                for r in resources:
                    sh_r = pool_sh[r][pa].copy()
                    _mutate_shares(rng, sh_r, m, 0.3,
                                   0.2 * cfg.share_sigma)
                    kid_sh[r] = sh_r
                if hybrid:
                    a = pool_sh["assign"][pa].copy()
                    _flip_assign(rng, a, m, 0.2 * cfg.assign_flip_frac)
                    kid_sh["assign"] = a
            else:
                kid_sh = {r: _breed_shares(rng, pool_sh[r], pa, pb, m, cfg)
                          for r in resources}
                if hybrid:
                    a = _crossover_assign(rng, pool_sh["assign"][pa].copy(),
                                          pool_sh["assign"][pb], m,
                                          cfg.assign_crossover_frac)
                    _merge_split_assign(rng, a, m, cfg.merge_split_frac)
                    _flip_assign(rng, a, m, cfg.assign_flip_frac)
                    kid_sh["assign"] = a
        if n_imm:
            imm = fresh_designs(n_imm)
            if exploit and not cfg.freeze_partition:
                pi = rng.integers(0, len(pool), size=n_imm)
                imm_sh = {r: pool_sh[r][pi].copy() for r in genes}
            else:
                imm_sh = fresh_shares(n_imm)
            kids = [concat_batches([k, i]) for k, i in zip(kids, imm)]
            kid_sh = {r: np.concatenate([kid_sh[r], imm_sh[r]])
                      for r in genes}
        pop_md = stack_designs(kids, max_m)
        pop_sh = kid_sh
        timings.append(dict(gen=gen, breed_s=time.perf_counter() - t_breed,
                            step_s=step_s))

        history.append(dict(gen=gen, evals=base, archive=len(archive),
                            best=dict(zip(objectives,
                                          archive.points.min(0).tolist()))
                            if len(archive) else {}))
        _gen_telemetry("multinet", gen, base,
                       archive.points if len(archive) else None,
                       {"mode": cfg.mode})

    seconds = time.time() - t0
    metrics = _merged_metrics(all_metrics)
    history.append(dict(gen=gens - 1, evals=total, archive=len(archive),
                        best=dict(zip(objectives,
                                      archive.points.min(0).tolist()))
                        if len(archive) else {}))
    _gen_telemetry("multinet", gens - 1, total,
                   archive.points if len(archive) else None,
                   {"mode": cfg.mode})
    return MultinetSearchResult(
        designs=MultiDesignBatch.from_numpy(hall_end, hall_pipe, hall_nce,
                                            hall_inter),
        shares=hall_sh, metrics=metrics, points=all_points,
        front_idx=np.sort(archive.payload.copy()),
        objectives=objectives, mode=cfg.mode, n_evals=total,
        seconds=seconds, history=history, timings=timings)
