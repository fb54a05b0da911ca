"""Guided multi-objective search over DesignBatch arrays (paper use case 3).

The port of the JAX package's ``core/dse/search.py``.  An evolutionary
loop mutates and recombines whole *batches* of designs between batch-path
evaluations, on the fixed-shape segment encoding.

Breeding is host numpy on ``np.random.default_rng``, operator for operator
the JAX package's (a copy of its code), so from one seed and the same
parents both packages draw the same children:

* segment-boundary shift   -- move one cut point +-1 layer;
* segment split / merge    -- insert or delete a cut point;
* CE-count perturbation    -- +-1 CE on one segment;
* pipeline-flag flip       -- toggle a segment between single-CE and a
                             2-CE pipelined block (canonical pipe <=> nce>1);
* inter-segment-pipelining flip;
* one-point crossover      -- child takes parent A's boundaries below a
                             random cut layer and parent B's above it.

Selection keeps a persistent :class:`ParetoArchive` (mode="pareto") or a
weighted-scalarization elite (mode="scalarized").

The generation step (:func:`search_step`) runs on the session's device:
constraint repair, the batch path (one ⟨pf, ph, pw⟩ search-kernel launch
per chunk of designs on the card), validity, objective orientation and
selection scoring.  Every sub-batch is padded to ``pop_size`` rows.  Per
generation the host pulls only the objective points (for the archive), the
validity mask, the scores and the repaired designs; the metrics stay on
the device until the end of the search.

The island model (``n_islands > 1``): sub-populations that evolve under
the same generation step, each on its own ``[seed, island]`` RNG stream,
with periodic migration of Pareto elites and a final merged front.  Under
a sharded mesh (``core.shard.EvalMesh``) of one device per island, island
i's generation step runs on ``mesh.devices[i]``, every island's step
enqueued before any is read back; otherwise the islands take turns through
the single-device step, as the JAX package runs them without a mesh.  Both
give the same designs and the same bits.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, fields as dc_fields

import numpy as np
import torch

from .. import resilience, telemetry
from ..resilience import EvalError
from .encoding import (NC, NS, DesignBatch, concat_batches,
                       repair_batch_torch, validate_batch_torch)
from .pareto import ParetoArchive, hypervolume_2d
from .samplers import sample_custom, sample_mixed

# metrics where HIGHER is better get flipped when building objective points
# (single-model metrics plus the multinet system metrics, as in the JAX
# package, so `orient` serves the joint searches too)
ORIENT_MAX = frozenset({"throughput_ips", "utilization",
                        "agg_throughput_ips", "min_model_throughput_ips",
                        "fairness", "slo_attainment",
                        "slo_attainment_dist"})


def orient(metrics: dict[str, np.ndarray],
           objectives: tuple[str, ...]) -> np.ndarray:
    """Stack selected metrics into (N, M) points, lower always better."""
    cols = [(-1.0 if k in ORIENT_MAX else 1.0) * np.asarray(metrics[k],
                                                            np.float64)
            for k in objectives]
    return np.stack(cols, axis=1)


@dataclass
class SearchConfig:
    pop_size: int = 4096
    budget: int = 100_000             # total design evaluations
    objectives: tuple[str, ...] = ("latency_s", "buffer_bytes")
    mode: str = "pareto"              # "pareto" | "scalarized"
    weights: tuple[float, ...] | None = None   # scalarized-mode weights
    min_ces: int = 2
    max_ces: int = 11
    seed: int = 0
    crossover_frac: float = 0.5
    shift_frac: float = 0.6
    split_frac: float = 0.15
    merge_frac: float = 0.15
    nce_frac: float = 0.4
    flip_frac: float = 0.15
    inter_frac: float = 0.1
    immigrant_frac: float = 0.15      # fresh random designs per generation
    elite_frac: float = 0.25          # scalarized top-slice joining parents
    init_family: str = "both"         # sampler for init/immigrants:
                                      # "custom" | "mixed" | "both"
    # ---- island model ---------------------------------------------------
    n_islands: int | None = None      # None: the mesh's device count when
                                      # search() gets a sharded mesh, else
                                      # 1 -- the classic single-population
                                      # loop
    migration_interval: int = 4       # generations between elite exchanges
    migration_elites: int = 8         # per-island elites broadcast at each
                                      # migration (0 disables migration)
    # ---- checkpoint/resume --------------------------------------------
    checkpoint_path: str | None = None  # snapshot file; None disables
    checkpoint_interval: int = 8      # generations between snapshots
    resume: bool = False              # resume from checkpoint_path if it
                                      # exists (a resumed run is
                                      # bit-identical to an uninterrupted
                                      # one); missing file = fresh start


@dataclass
class SearchResult:
    batch: DesignBatch                # every evaluated design, in order,
                                      # on the host (CPU tensors)
    metrics: dict[str, np.ndarray]
    points: np.ndarray                # (n_evals, M) oriented objectives
    front_idx: np.ndarray             # archive rows, as indices into batch
    objectives: tuple[str, ...]
    n_evals: int
    seconds: float
    history: list[dict] = field(default_factory=list)
    #: per generation: host seconds breeding the next population
    #: (``breed_s``, 0 for the last) and seconds of the device step with
    #: its pulls (``step_s``)
    timings: list[dict] = field(default_factory=list)
    island_fronts: list = field(default_factory=list)  # per-island front
                                      # indices into batch ([] single-pop)


# --------------------------------------------------------------------------
# boundary-bitmask domain: (P, L+1) cut mask + per-cut CE count
# --------------------------------------------------------------------------
def _to_boundary(seg_end: np.ndarray, seg_nce: np.ndarray,
                 n_layers: int) -> tuple[np.ndarray, np.ndarray]:
    P = len(seg_end)
    prev = np.concatenate(
        [np.zeros((P, 1), seg_end.dtype), seg_end[:, :-1]], axis=1)
    active = seg_end > prev
    bnd = np.zeros((P, n_layers + 1), bool)
    nce_at = np.ones((P, n_layers + 1), np.int64)
    rows = np.nonzero(active)[0]
    ends = seg_end[active].astype(np.int64)
    bnd[rows, ends] = True
    nce_at[rows, ends] = seg_nce[active]
    return bnd, nce_at


def _from_boundary(bnd: np.ndarray, nce_at: np.ndarray, n_layers: int,
                   max_segments: int) -> tuple[np.ndarray, np.ndarray]:
    """Compress the bitmask back to canonical (P, NS) arrays, keeping at
    most ``max_segments`` segments (surplus cut points merge away)."""
    P = bnd.shape[0]
    bnd = bnd.copy()
    bnd[:, 0] = False
    bnd[:, n_layers] = True
    internal = bnd.copy()
    internal[:, n_layers] = False
    irank = np.cumsum(internal, axis=1)
    keep = internal & (irank <= min(NS, max_segments) - 1)
    keep[:, n_layers] = True
    rows, poss = np.nonzero(keep)
    counts = np.bincount(rows, minlength=P)
    col = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts, counts)
    seg_end = np.full((P, NS), n_layers, np.int64)
    seg_end[rows, col] = poss
    seg_nce = np.ones((P, NS), np.int64)
    seg_nce[rows, col] = nce_at[rows, poss]
    return seg_end, seg_nce


def _pick(rng: np.random.Generator,
          mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One uniformly random True column per row -> (has_any, col)."""
    keys = np.where(mask, rng.random(mask.shape), -1.0)
    return mask.any(1), np.argmax(keys, axis=1)


def _crossover(rng, bnd_a, nce_a, bnd_b, nce_b, frac):
    P, W = bnd_a.shape
    cut = rng.integers(1, max(W - 1, 2), size=P)
    do = (rng.random(P) < frac)[:, None]
    left = np.arange(W)[None, :] <= cut[:, None]
    bnd = np.where(do, np.where(left, bnd_a, bnd_b), bnd_a)
    nce = np.where(do, np.where(left, nce_a, nce_b), nce_a)
    return bnd, nce


def _op_shift(rng, bnd, nce_at, frac):
    P, W = bnd.shape
    internal = bnd.copy()
    internal[:, 0] = internal[:, W - 1] = False
    has, col = _pick(rng, internal)
    tgt = np.clip(col + np.where(rng.random(P) < 0.5, -1, 1), 1, W - 2)
    do = has & (rng.random(P) < frac) & (tgt != col) \
        & ~bnd[np.arange(P), tgt]
    r = np.nonzero(do)[0]
    bnd[r, tgt[r]] = True
    nce_at[r, tgt[r]] = nce_at[r, col[r]]
    bnd[r, col[r]] = False
    nce_at[r, col[r]] = 1


def _op_split(rng, bnd, nce_at, frac):
    P, W = bnd.shape
    inner = ~bnd
    inner[:, 0] = inner[:, W - 1] = False
    has, col = _pick(rng, inner)
    do = has & (rng.random(P) < frac)
    r = np.nonzero(do)[0]
    bnd[r, col[r]] = True
    nce_at[r, col[r]] = 1            # new left half starts single-CE


def _op_merge(rng, bnd, nce_at, frac):
    P, W = bnd.shape
    internal = bnd.copy()
    internal[:, 0] = internal[:, W - 1] = False
    has, col = _pick(rng, internal)
    do = has & (rng.random(P) < frac)
    r = np.nonzero(do)[0]
    bnd[r, col[r]] = False
    nce_at[r, col[r]] = 1


def _op_nce(rng, bnd, nce_at, frac):
    P, W = bnd.shape
    cuts = bnd.copy()
    cuts[:, W - 1] = True            # the final segment is perturbable too
    cuts[:, 0] = False
    has, col = _pick(rng, cuts)
    do = has & (rng.random(P) < frac)
    delta = np.where(rng.random(P) < 0.5, -1, 1)
    r = np.nonzero(do)[0]
    nce_at[r, col[r]] = np.clip(nce_at[r, col[r]] + delta[r], 1, NC)


def _op_flip(rng, bnd, nce_at, frac):
    cuts = bnd.copy()
    cuts[:, -1] = True
    cuts[:, 0] = False
    has, col = _pick(rng, cuts)
    do = has & (rng.random(len(bnd)) < frac)
    r = np.nonzero(do)[0]
    cur = nce_at[r, col[r]]
    nce_at[r, col[r]] = np.where(cur > 1, 1, 2)   # pipe <-> single


def _repair_ces(seg_end, seg_nce, min_ces, max_ces, rng):
    """Bounded take-from-largest / give-to-random passes until every row's
    total CE count sits in [min_ces, min(max_ces, NC)]."""
    cap = min(max_ces, NC)
    P = len(seg_end)
    prev = np.concatenate(
        [np.zeros((P, 1), seg_end.dtype), seg_end[:, :-1]], axis=1)
    active = seg_end > prev
    nce = np.where(active, seg_nce, 1)
    rows = np.arange(P)
    for _ in range(2 * NC):
        total = (nce * active).sum(1)
        over = total > cap
        if not over.any():
            break
        shrinkable = active & (nce > 1)
        cand = np.where(shrinkable, nce.astype(np.float64), -np.inf)
        col = np.argmax(cand + rng.random(cand.shape) * 0.5, axis=1)
        sel = over & shrinkable.any(1)
        if not sel.any():
            break
        r = rows[sel]
        nce[r, col[sel]] -= 1
    for _ in range(2 * NC):
        total = (nce * active).sum(1)
        under = total < min_ces
        if not under.any():
            break
        has, col = _pick(rng, active)
        r = rows[under & has]
        nce[r, col[under & has]] += 1
    return np.where(active, nce, 1)


def make_children(rng: np.random.Generator, parents: DesignBatch,
                  n_layers: int, cfg: SearchConfig, n: int) -> DesignBatch:
    """Breed ``n`` children from ``parents`` (crossover + mutation ops),
    returning canonical, constraint-repaired designs."""
    seg_end, _, seg_nce, inter = parents.to_numpy()
    pa = rng.integers(0, len(seg_end), size=n)
    pb = rng.integers(0, len(seg_end), size=n)
    bnd_a, nce_a = _to_boundary(seg_end[pa], seg_nce[pa], n_layers)
    bnd_b, nce_b = _to_boundary(seg_end[pb], seg_nce[pb], n_layers)
    bnd, nce_at = _crossover(rng, bnd_a, nce_a, bnd_b, nce_b,
                             cfg.crossover_frac)
    _op_shift(rng, bnd, nce_at, cfg.shift_frac)
    _op_split(rng, bnd, nce_at, cfg.split_frac)
    _op_merge(rng, bnd, nce_at, cfg.merge_frac)
    _op_nce(rng, bnd, nce_at, cfg.nce_frac)
    _op_flip(rng, bnd, nce_at, cfg.flip_frac)
    end, nce = _from_boundary(bnd, nce_at, n_layers,
                              max_segments=min(NS, cfg.max_ces))
    nce = _repair_ces(end, nce, cfg.min_ces, cfg.max_ces, rng)
    prev = np.concatenate([np.zeros((n, 1), end.dtype), end[:, :-1]], axis=1)
    pipe = (end > prev) & (nce > 1)
    child_inter = np.where(rng.random(n) < cfg.inter_frac,
                           ~inter[pa], inter[pa])
    return DesignBatch.from_numpy(end, pipe, nce, child_inter)


# --------------------------------------------------------------------------
# the generation step, on the session's device
# --------------------------------------------------------------------------
def search_step(design: DesignBatch, tables, devt, w: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor, *,
                objectives: tuple[str, ...], min_ces: int, max_ces: int,
                tile: int, chunk: int, pairs=None):
    """One (sub-)generation on the tables' device: constraint repair, the
    batch path, validity, objective orientation and selection scoring.

    Returns ``(design, metrics, pts, ok, score, lo, hi)``: the repaired
    design, the metric tensors, the (B, M) f32 oriented points, the bool
    validity mask, the f32 scores and the updated per-objective bounds.
    The score is the JAX step's ``((pts - lo) / span) @ w`` as a
    fixed-order f32 sum over the objectives (:func:`_weighted_sum`).
    ``tables`` and ``devt`` are the batch path's ``NetTables`` and
    ``DeviceTables``, ``tile`` and ``chunk`` its blocks, ``pairs`` its
    pair tables when the caller built them (``batch_eval.search_setup``).
    """
    from ..batch_eval import evaluate_batch

    design = repair_batch_torch(design, tables.L, min_ces=min_ces,
                                max_ces=max_ces)
    metrics = evaluate_batch(design, tables, devt, tile=tile, chunk=chunk,
                             pairs=pairs)
    pts = torch.stack([(-1.0 if k in ORIENT_MAX else 1.0) * metrics[k]
                       for k in objectives], 1)
    ok = validate_batch_torch(design, tables.L, min_ces=min_ces,
                              max_ces=max_ces)
    ok &= torch.isfinite(pts).all(1)
    inf = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    lo = torch.minimum(lo, torch.where(ok[:, None], pts, inf).amin(0))
    hi = torch.maximum(hi, torch.where(ok[:, None], pts, -inf).amax(0))
    span = torch.clamp_min(hi - lo, 1e-30)
    score = torch.where(ok, _weighted_sum((pts - lo) / span, w), inf)
    return design, metrics, pts, ok, score, lo, hi


def _weighted_sum(norm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``norm @ w`` in f32 in the order XLA's CPU dot takes: the first
    product rounded, then each further term added by a fused multiply-add
    (the product unrounded, one rounding of the sum).  The fused step is
    computed in f64, where an f32 product is exact, and rounded to f32:
    it parts from a true fused multiply-add only where the f64 sum falls
    exactly on an f32 rounding midpoint.  Elementwise on the device: no
    tensor-core product and no TF32 decides a choice."""
    acc = norm[:, 0] * w[0]
    for j in range(1, norm.shape[1]):
        acc = (norm[:, j].double() * w[j].double() + acc.double()).float()
    return acc


# --------------------------------------------------------------------------
# checkpoint plumbing (shared by the serial and island loops)
# --------------------------------------------------------------------------
#: the checkpoint kinds the serial and the island loop write
_CKPT_KINDS = ("dse-search", "dse-search-island")


def _cfg_fingerprint(cfg, n_layers: int | tuple[int, ...]) -> dict:
    """The search-trajectory-determining identity a checkpoint is bound
    to: every config field except the checkpoint knobs themselves, plus
    the workload size (a net's layer count, or each net's for multinet).
    A resume under a different fingerprint would NOT reproduce the
    uninterrupted run, so it is refused."""
    skip = {"checkpoint_path", "checkpoint_interval", "resume"}
    fp = {f.name: getattr(cfg, f.name) for f in dc_fields(cfg)
          if f.name not in skip}
    fp["n_layers"] = n_layers
    return fp


def _checkpoint_meta(cfg, n_layers: int | tuple[int, ...]) -> dict:
    return {"fingerprint": _cfg_fingerprint(cfg, n_layers)}


def _load_search_checkpoint(cfg, n_layers: int | tuple[int, ...],
                            kind: str) -> dict | None:
    """The state dict of a resumable checkpoint, or None for a fresh
    start (no path / resume off / file absent)."""
    path = cfg.checkpoint_path
    if not path or not cfg.resume or not os.path.exists(path):
        return None
    snap = resilience.load_checkpoint(path, kind=kind)
    want = _cfg_fingerprint(cfg, n_layers)
    if snap["meta"].get("fingerprint") != want:
        raise EvalError(
            EvalError.INVALID_INPUT,
            f"checkpoint {path} was written by a different search "
            f"configuration/workload; refusing to resume (a resumed run "
            f"must be bit-identical to an uninterrupted one)")
    return snap["state"]


def _best_scalar_idx(cfg, hall_ok, all_points, lo_h, hi_h) -> int:
    """The best single design under one CONSISTENT scalarization (the
    final normalization span ``lo_h``..``hi_h``, f64 on the host; the
    configured weights, equal if none)."""
    w = np.asarray(cfg.weights) if cfg.weights is not None \
        else np.ones(len(cfg.objectives))
    w = w / w.sum()
    final_scores = np.where(
        hall_ok,
        ((all_points - lo_h) / np.maximum(hi_h - lo_h, 1e-30)) @ w, np.inf)
    return int(np.argmin(final_scores))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _merged_metrics(all_metrics: list[dict]) -> dict:
    """One host dict over everything evaluated so far (device slices are
    pulled once, here)."""
    if not all_metrics:
        return {}
    return {k: np.concatenate([_host(m[k]) for m in all_metrics])
            for k in all_metrics[0]}


# --------------------------------------------------------------------------
# the search loop
# --------------------------------------------------------------------------
def _initial_pop(rng, n_layers, cfg, n):
    fam = cfg.init_family
    if fam not in ("custom", "mixed", "both"):
        raise ValueError(f"unknown init_family {fam!r}")
    if cfg.max_ces < 2 or fam == "mixed":   # custom needs a >= 2-CE head
        return sample_mixed(rng, n_layers, n,
                            min_ces=cfg.min_ces, max_ces=cfg.max_ces)
    if fam == "custom":
        return sample_custom(rng, n_layers, n,
                             min_ces=max(cfg.min_ces, 2),
                             max_ces=cfg.max_ces)
    n_custom = n // 2
    a = sample_custom(rng, n_layers, n_custom,
                      min_ces=max(cfg.min_ces, 2), max_ces=cfg.max_ces)
    b = sample_mixed(rng, n_layers, n - n_custom,
                     min_ces=cfg.min_ces, max_ces=cfg.max_ces)
    return concat_batches([a, b])


def _gen_telemetry(kind: str, gen: int, evals: int, points,
                   extra: dict | None = None) -> None:
    """Per-generation search telemetry: a generation counter, the current
    front size, the 2-objective dominated hypervolume (ref = the front's
    own max corner, so it is monotone in front quality without needing a
    user reference), and one trace event.  No-op -- no host pulls, no
    allocation -- when telemetry is disabled."""
    if not telemetry.enabled():
        return
    telemetry.count(f"{kind}.generations")
    front = 0 if points is None else len(points)
    telemetry.gauge(f"{kind}.front_size", front)
    attrs = {"gen": gen, "evals": evals, "front": front}
    if extra:
        attrs.update(extra)
    if points is not None and front and points.shape[1] == 2:
        ref = points.max(0) * 1.1 + 1e-30
        hv = hypervolume_2d(points, ref)
        telemetry.gauge(f"{kind}.hypervolume", hv)
        attrs["hypervolume"] = hv
    telemetry.event(f"{kind}.generation", attrs)


def search(net, dev, config: SearchConfig | None = None, tables=None, *,
           device="cuda", tile: int | None = None,
           chunk: int | None = None, mesh=None) -> SearchResult:
    """Run the guided loop: sample -> evaluate -> archive -> breed.

    The step runs on the device of ``tables`` (``NetTables``) when given
    (used verbatim), else on ``device``, where ``net``'s tables are built.
    ``dev`` is a board (``DeviceSpec``) or its ``DeviceTables`` on that
    device.  ``tile`` and ``chunk`` are the batch path's blocks on the CPU
    and on the card (None: its defaults).

    ``mesh`` (a ``core.shard.EvalMesh``) turns the loop into an island
    model, one sub-population per device, via ``cfg.n_islands`` (None
    resolves to the mesh's device count).  With one island the classic
    single-population loop below runs unchanged.
    """
    from ..batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, _pad_rows,
                              make_tables, search_setup)

    cfg = config or SearchConfig()
    n_obj = len(cfg.objectives)
    if cfg.budget < 1 or cfg.pop_size < 1:
        raise ValueError(
            f"budget and pop_size must be >= 1 "
            f"(got {cfg.budget}, {cfg.pop_size})")
    if cfg.mode not in ("pareto", "scalarized"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.mode == "scalarized" and cfg.weights is not None \
            and len(cfg.weights) != n_obj:
        raise ValueError("weights must match objectives")
    n_islands = cfg.n_islands
    if n_islands is None:
        n_islands = mesh.ndevices \
            if mesh is not None and getattr(mesh, "is_sharded", False) else 1
    if n_islands < 1:
        raise ValueError(f"n_islands must be >= 1, got {n_islands}")
    n_islands = min(n_islands, cfg.budget)
    tables = tables if tables is not None \
        else make_tables(net, device=device)
    device = tables.device
    # the board's tables and the pair list, built once for every step
    devt, pairs = search_setup(tables, dev)
    statics = dict(objectives=tuple(cfg.objectives), min_ces=cfg.min_ces,
                   max_ces=cfg.max_ces, tile=tile or DEFAULT_TILE,
                   chunk=chunk or DEFAULT_CHUNK)
    if n_islands > 1:
        return _island_search(cfg, tables, devt, pairs, statics, n_islands,
                              mesh)

    n_layers = tables.L
    rng = np.random.default_rng(cfg.seed)

    # generation sizes: pop_n each, the final one absorbing the remainder
    # so the evaluation count equals the budget EXACTLY.  Every device
    # call is padded to pop_n rows (the final oversized generation splits
    # into pop_n-shaped sub-batches)
    pop_n = min(cfg.pop_size, cfg.budget)
    gens = max(1, cfg.budget // pop_n)
    sizes = [pop_n] * gens
    sizes[-1] += cfg.budget - gens * pop_n
    total = cfg.budget

    hall_end = np.empty((total, NS), np.int32)
    hall_pipe = np.empty((total, NS), bool)
    hall_nce = np.empty((total, NS), np.int32)
    hall_inter = np.empty((total,), bool)
    all_points = np.empty((total, n_obj))
    hall_ok = np.zeros((total,), bool)
    all_metrics: list[dict] = []
    timings: list[dict] = []

    archive = ParetoArchive(n_obj)
    lo = torch.full((n_obj,), float("inf"), dtype=torch.float32,
                    device=device)
    hi = torch.full((n_obj,), float("-inf"), dtype=torch.float32,
                    device=device)
    history: list[dict] = []

    def eval_gen(pop: DesignBatch, w, lo, hi):
        """Evaluate a generation in pop_n-shaped padded sub-batches."""
        n = pop.batch
        w_t = torch.tensor(w, dtype=torch.float32, device=device)
        pts_l, ok_l, score_l, design_l = [], [], [], []
        for s in range(0, n, pop_n):
            keep = min(s + pop_n, n) - s
            sub = _pad_rows(pop.take(slice(s, s + keep)).to(device), pop_n)
            design, metrics, pts, ok, score, lo, hi = search_step(
                sub, tables, devt, w_t, lo, hi, pairs=pairs, **statics)
            all_metrics.append({k: v[:keep] for k, v in metrics.items()})
            design_l.append([a[:keep].cpu().numpy() for a in (
                design.seg_end, design.seg_pipe, design.seg_nce,
                design.inter_pipe)])
            pts_l.append(pts[:keep].cpu().numpy().astype(np.float64))
            ok_l.append(ok[:keep].cpu().numpy())
            score_l.append(score[:keep].cpu().numpy().astype(np.float64))
        cat = lambda xs: np.concatenate(xs) if len(xs) > 1 else xs[0]
        darrs = [cat([d[i] for d in design_l]) for i in range(4)]
        return darrs, cat(pts_l), cat(ok_l), cat(score_l), lo, hi

    # ---- checkpoint/resume: restore loop state exactly as it was at
    # the top of generation `start_gen` (before that gen's RNG draws),
    # so the remaining generations replay bit-identically --------------
    start_gen, base, elapsed0, pop = 0, 0, 0.0, None
    snap = _load_search_checkpoint(cfg, n_layers, "dse-search")
    if snap is not None:
        start_gen, base = snap["gen"], snap["base"]
        rng = resilience.rng_from_state(snap["rng"])
        pop = DesignBatch.from_numpy(*snap["pop"])
        hall_end[:base], hall_pipe[:base] = snap["hall"][0], snap["hall"][1]
        hall_nce[:base], hall_inter[:base] = snap["hall"][2], snap["hall"][3]
        all_points[:base] = snap["points"]
        hall_ok[:base] = snap["ok"]
        if snap["metrics"]:
            all_metrics.append(snap["metrics"])
        archive.points = snap["archive"][0].copy()
        archive.payload = snap["archive"][1].copy()
        lo = torch.from_numpy(snap["lo"]).to(device)
        hi = torch.from_numpy(snap["hi"]).to(device)
        history.extend(snap["history"])
        elapsed0 = snap["elapsed_s"]
    if pop is None:
        pop = _initial_pop(rng, n_layers, cfg, sizes[0])
    ckpt_every = max(1, cfg.checkpoint_interval)
    t0 = time.time() - elapsed0
    for gen in range(start_gen, gens):
        if cfg.checkpoint_path and gen > 0 and gen % ckpt_every == 0:
            resilience.save_checkpoint(
                cfg.checkpoint_path, "dse-search",
                {"gen": gen, "base": base,
                 "rng": resilience.rng_state(rng),
                 "pop": tuple(pop.to_numpy()),
                 "hall": (hall_end[:base].copy(), hall_pipe[:base].copy(),
                          hall_nce[:base].copy(), hall_inter[:base].copy()),
                 "points": all_points[:base].copy(),
                 "ok": hall_ok[:base].copy(),
                 "metrics": _merged_metrics(all_metrics),
                 "archive": (archive.points.copy(), archive.payload.copy()),
                 "lo": lo.cpu().numpy(), "hi": hi.cpu().numpy(),
                 "history": list(history),
                 "elapsed_s": time.time() - t0},
                meta=_checkpoint_meta(cfg, n_layers))
        if cfg.mode == "scalarized":
            w = np.asarray(cfg.weights if cfg.weights is not None
                           else np.ones(n_obj))
        else:
            w = rng.random(n_obj) + 0.1       # fresh direction each gen
        w = w / w.sum()

        t_step = time.perf_counter()
        (e, p, c, i), pts, ok, score, lo, hi = eval_gen(pop, w, lo, hi)
        step_s = time.perf_counter() - t_step
        idx = np.arange(base, base + sizes[gen])
        base += sizes[gen]
        hall_end[idx], hall_pipe[idx] = e, p
        hall_nce[idx], hall_inter[idx] = c, i
        all_points[idx] = pts
        hall_ok[idx] = ok
        archive.update(pts[ok], idx[ok])

        if gen == gens - 1:
            timings.append(dict(gen=gen, breed_s=0.0, step_s=step_s))
            break

        # ---- parents: archive front + this generation's elite slice ----
        t_breed = time.perf_counter()
        n_elite = max(1, int(sizes[gen] * cfg.elite_frac))
        elite = idx[np.argsort(score, kind="stable")[:n_elite]]
        pool = np.unique(np.concatenate([archive.payload, elite]))
        parents = DesignBatch.from_numpy(
            hall_end[pool], hall_pipe[pool], hall_nce[pool], hall_inter[pool])

        n_imm = int(sizes[gen + 1] * cfg.immigrant_frac)
        children = make_children(rng, parents, n_layers, cfg,
                                 sizes[gen + 1] - n_imm)
        imm = _initial_pop(rng, n_layers, cfg, n_imm) if n_imm else None
        pop = concat_batches([children, imm]) if imm is not None else children
        timings.append(dict(gen=gen, breed_s=time.perf_counter() - t_breed,
                            step_s=step_s))

        history.append(dict(gen=gen, evals=base,
                            archive=len(archive),
                            best=dict(zip(cfg.objectives,
                                          archive.points.min(0).tolist()))
                            if len(archive) else {}))
        _gen_telemetry("dse", gen, base,
                       archive.points if len(archive) else None)

    seconds = time.time() - t0
    # one host pull per metric for the whole search (they stayed on device)
    metrics = _merged_metrics(all_metrics)
    best_scalar_idx = _best_scalar_idx(
        cfg, hall_ok, all_points, lo.cpu().numpy().astype(np.float64),
        hi.cpu().numpy().astype(np.float64))
    history.append(dict(gen=gens - 1, evals=total, archive=len(archive),
                        best=dict(zip(cfg.objectives,
                                      archive.points.min(0).tolist()))
                        if len(archive) else {},
                        best_scalar_idx=best_scalar_idx))
    _gen_telemetry("dse", gens - 1, total,
                   archive.points if len(archive) else None)
    return SearchResult(
        batch=DesignBatch.from_numpy(hall_end, hall_pipe, hall_nce,
                                     hall_inter),
        metrics=metrics,
        points=all_points,
        front_idx=np.sort(archive.payload.copy()),
        objectives=cfg.objectives,
        n_evals=total,
        seconds=seconds,
        history=history,
        timings=timings,
    )


# --------------------------------------------------------------------------
# the island model (serial islands on the tables' device)
# --------------------------------------------------------------------------
def _migration_pick(archive: ParetoArchive, k: int) -> np.ndarray:
    """Up to ``k`` elites from one island's front, spread along the first
    objective (deterministic -- no RNG, so migration never perturbs the
    per-island random streams)."""
    pay = archive.payload
    if len(pay) <= k:
        return pay.copy()
    order = np.argsort(archive.points[:, 0], kind="stable")
    sel = np.round(np.linspace(0, len(order) - 1, k)).astype(int)
    return pay[order[sel]]


def _island_search(cfg: SearchConfig, tables, devt, pairs, statics: dict,
                   n_islands: int, mesh=None) -> SearchResult:
    """The island model: ``n_islands`` sub-populations, each evolving
    under the same generation step (:func:`search_step`), with periodic
    migration of Pareto elites between islands and a final merged-front
    reduction.

    Each island's sub-batch is padded to ``pop_n`` rows under the
    island's own weight and normalization rows, and island i's step runs
    on device i of a mesh: a sharded ``mesh`` with one device per island,
    else the tables' device named once per island (the JAX package's
    serial island loop).  The tables and the pair list are copied once to
    each distinct device, every island's step is enqueued before any is
    read back, and the results and the lo/hi planes are gathered on the
    tables' device.  Both meshes give the same bits, so a sharded and a
    serial run write the same checkpoints.  Breeding stays host-side per
    island (``make_children``), each island on its own ``[seed, island]``
    RNG stream, so results are deterministic given (seed, island count)."""
    from ..batch_eval import _pad_rows

    n_obj = len(cfg.objectives)
    n_layers = tables.L
    device = tables.device
    I = n_islands

    # per-generation island sizes: pop_n each, the final generation
    # absorbing the remainder so evaluations equal the budget EXACTLY;
    # every step call is padded to pop_n rows
    pop_n = min(cfg.pop_size, max(cfg.budget // I, 1))
    per_gen = pop_n * I
    gens = max(1, cfg.budget // per_gen)
    sizes = np.full((gens, I), pop_n, np.int64)
    rem = cfg.budget - gens * per_gen
    sizes[-1] += rem // I
    sizes[-1, :rem % I] += 1
    total = cfg.budget

    from ..shard import EvalMesh, _map

    if not (mesh is not None and getattr(mesh, "is_sharded", False)
            and mesh.ndevices == I):
        mesh = EvalMesh(devices=[device] * I)
    shared = mesh.replicate((tables, devt, pairs))
    home = lambda x: _map(x, lambda t: t.to(device))

    def step_all(subs, w_t, lo, hi):
        """Island i's sub-batch through the generation step on device i
        of the mesh, under its own weight and normalization rows."""
        outs = mesh.run_shards(
            lambda sub, t, dv, pr, w, l, h: search_step(
                sub, t, dv, w, l, h, pairs=pr, **statics),
            [(subs[i].to(d), *shared[d], w_t[i].to(d), lo[i].to(d),
              hi[i].to(d)) for i, d in enumerate(mesh.devices)])
        return ([home(o[:5]) for o in outs],
                torch.stack([o[5].to(device) for o in outs]),
                torch.stack([o[6].to(device) for o in outs]))

    hall_end = np.empty((total, NS), np.int32)
    hall_pipe = np.empty((total, NS), bool)
    hall_nce = np.empty((total, NS), np.int32)
    hall_inter = np.empty((total,), bool)
    all_points = np.empty((total, n_obj))
    hall_ok = np.zeros((total,), bool)
    all_metrics: list[dict] = []
    timings: list[dict] = []

    merged = ParetoArchive(n_obj)
    islands = [ParetoArchive(n_obj) for _ in range(I)]
    rngs = [np.random.default_rng([cfg.seed, i]) for i in range(I)]
    lo = torch.full((I, n_obj), float("inf"), dtype=torch.float32,
                    device=device)
    hi = torch.full((I, n_obj), float("-inf"), dtype=torch.float32,
                    device=device)
    history: list[dict] = []

    # ---- checkpoint/resume (same contract as the serial loop, with
    # per-island RNG streams / populations / archives in the state) ----
    start_gen, base, elapsed0 = 0, 0, 0.0
    snap = _load_search_checkpoint(cfg, n_layers, "dse-search-island")
    if snap is None:
        pops = [_initial_pop(rngs[i], n_layers, cfg, int(sizes[0, i]))
                for i in range(I)]
    else:
        start_gen, base = snap["gen"], snap["base"]
        rngs = [resilience.rng_from_state(s) for s in snap["rngs"]]
        pops = [DesignBatch.from_numpy(*p) for p in snap["pops"]]
        hall_end[:base], hall_pipe[:base] = snap["hall"][0], snap["hall"][1]
        hall_nce[:base], hall_inter[:base] = snap["hall"][2], snap["hall"][3]
        all_points[:base] = snap["points"]
        hall_ok[:base] = snap["ok"]
        if snap["metrics"]:
            all_metrics.append(snap["metrics"])
        for arch, (apts, apay) in zip(islands, snap["islands"]):
            arch.points, arch.payload = apts.copy(), apay.copy()
        merged.points = snap["merged"][0].copy()
        merged.payload = snap["merged"][1].copy()
        lo = torch.from_numpy(snap["lo"]).to(device)
        hi = torch.from_numpy(snap["hi"]).to(device)
        history.extend(snap["history"])
        elapsed0 = snap["elapsed_s"]
    ckpt_every = max(1, cfg.checkpoint_interval)
    t0 = time.time() - elapsed0
    for gen in range(start_gen, gens):
        if cfg.checkpoint_path and gen > 0 and gen % ckpt_every == 0:
            resilience.save_checkpoint(
                cfg.checkpoint_path, "dse-search-island",
                {"gen": gen, "base": base,
                 "rngs": [resilience.rng_state(r) for r in rngs],
                 "pops": [tuple(p.to_numpy()) for p in pops],
                 "hall": (hall_end[:base].copy(), hall_pipe[:base].copy(),
                          hall_nce[:base].copy(), hall_inter[:base].copy()),
                 "points": all_points[:base].copy(),
                 "ok": hall_ok[:base].copy(),
                 "metrics": _merged_metrics(all_metrics),
                 "islands": [(a.points.copy(), a.payload.copy())
                             for a in islands],
                 "merged": (merged.points.copy(), merged.payload.copy()),
                 "lo": lo.cpu().numpy(), "hi": hi.cpu().numpy(),
                 "history": list(history),
                 "elapsed_s": time.time() - t0},
                meta=_checkpoint_meta(cfg, n_layers))
        ws = []
        for i in range(I):
            if cfg.mode == "scalarized":
                w = np.asarray(cfg.weights if cfg.weights is not None
                               else np.ones(n_obj))
            else:
                w = rngs[i].random(n_obj) + 0.1   # per-island direction
            ws.append(w / w.sum())
        w_t = torch.tensor(np.asarray(ws, np.float32), device=device)

        # sub-rounds: only the final (oversized) generation needs k > 1
        t_step = time.perf_counter()
        k = -(-int(sizes[gen].max()) // pop_n)
        gen_idx = [[] for _ in range(I)]
        gen_score = [[] for _ in range(I)]
        for j in range(k):
            subs, keeps = [], []
            for i in range(I):
                s = j * pop_n
                e = min(int(sizes[gen, i]), s + pop_n)
                keep = max(e - s, 0)
                # an island with nothing left passes one padded row
                rows = slice(s, e) if keep else slice(0, 1)
                subs.append(_pad_rows(pops[i].take(rows).to(device), pop_n))
                keeps.append(keep)
            parts, lo, hi = step_all(subs, w_t, lo, hi)
            for i in range(I):
                keep = keeps[i]
                if keep == 0:
                    continue
                design, metrics, pts, ok, score = parts[i]
                idx = np.arange(base, base + keep)
                base += keep
                e_h, p_h, c_h, i_h = (a[:keep].cpu().numpy() for a in (
                    design.seg_end, design.seg_pipe, design.seg_nce,
                    design.inter_pipe))
                hall_end[idx], hall_pipe[idx] = e_h, p_h
                hall_nce[idx], hall_inter[idx] = c_h, i_h
                pts_h = pts[:keep].cpu().numpy().astype(np.float64)
                ok_h = ok[:keep].cpu().numpy()
                all_points[idx] = pts_h
                hall_ok[idx] = ok_h
                all_metrics.append({kk: vv[:keep]
                                    for kk, vv in metrics.items()})
                gen_idx[i].append(idx)
                gen_score[i].append(
                    score[:keep].cpu().numpy().astype(np.float64))
                islands[i].update(pts_h[ok_h], idx[ok_h])
                merged.update(pts_h[ok_h], idx[ok_h])
        step_s = time.perf_counter() - t_step

        if gen == gens - 1:
            timings.append(dict(gen=gen, breed_s=0.0, step_s=step_s))
            break

        # ---- migration: every island's elite slice to every island ----
        t_breed = time.perf_counter()
        migrate = (cfg.migration_elites > 0 and cfg.migration_interval > 0
                   and (gen + 1) % cfg.migration_interval == 0)
        migrants = np.empty(0, np.int64)
        if migrate:
            picks = [_migration_pick(islands[i], cfg.migration_elites)
                     for i in range(I)]
            migrants = np.unique(np.concatenate(picks))

        # ---- per-island breeding: front + elite slice (+ migrants) ----
        for i in range(I):
            idx_i = np.concatenate(gen_idx[i])
            score_i = np.concatenate(gen_score[i])
            n_elite = max(1, int(len(idx_i) * cfg.elite_frac))
            elite = idx_i[np.argsort(score_i, kind="stable")[:n_elite]]
            pool = [islands[i].payload, elite]
            if migrate:
                pool.append(migrants)
            pool = np.unique(np.concatenate(pool))
            parents = DesignBatch.from_numpy(
                hall_end[pool], hall_pipe[pool], hall_nce[pool],
                hall_inter[pool])
            nxt = int(sizes[gen + 1, i])
            n_imm = int(nxt * cfg.immigrant_frac)
            children = make_children(rngs[i], parents, n_layers, cfg,
                                     nxt - n_imm)
            imm = _initial_pop(rngs[i], n_layers, cfg, n_imm) \
                if n_imm else None
            pops[i] = concat_batches([children, imm]) \
                if imm is not None else children
        timings.append(dict(gen=gen, breed_s=time.perf_counter() - t_breed,
                            step_s=step_s))

        history.append(dict(gen=gen, evals=base, archive=len(merged),
                            islands=[len(a) for a in islands],
                            migrants=int(len(migrants)),
                            best=dict(zip(cfg.objectives,
                                          merged.points.min(0).tolist()))
                            if len(merged) else {}))
        if len(migrants):
            telemetry.count("dse.migrations", int(len(migrants)))
        _gen_telemetry("dse", gen, base,
                       merged.points if len(merged) else None,
                       {"islands": len(islands),
                        "migrants": int(len(migrants))})

    seconds = time.time() - t0
    metrics = _merged_metrics(all_metrics)
    best_scalar_idx = _best_scalar_idx(
        cfg, hall_ok, all_points,
        lo.cpu().numpy().astype(np.float64).min(0),
        hi.cpu().numpy().astype(np.float64).max(0))
    history.append(dict(gen=gens - 1, evals=total, archive=len(merged),
                        islands=[len(a) for a in islands],
                        migrants=0,
                        best=dict(zip(cfg.objectives,
                                      merged.points.min(0).tolist()))
                        if len(merged) else {},
                        best_scalar_idx=best_scalar_idx))
    _gen_telemetry("dse", gens - 1, total,
                   merged.points if len(merged) else None,
                   {"islands": len(islands), "migrants": 0})
    return SearchResult(
        batch=DesignBatch.from_numpy(hall_end, hall_pipe, hall_nce,
                                     hall_inter),
        metrics=metrics,
        points=all_points,
        front_idx=np.sort(merged.payload.copy()),
        objectives=cfg.objectives,
        n_evals=total,
        seconds=seconds,
        history=history,
        timings=timings,
        island_fronts=[np.sort(a.payload.copy()) for a in islands],
    )
