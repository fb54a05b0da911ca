"""Joint cost model for M CNNs sharing one board.

A *deployment* row pairs M per-model multiple-CE designs with a resource
split (spatial mode), round-robin time shares (temporal mode), or a
spatial/shared assignment plus both (hybrid mode).  The per-model
``NetTables`` are held side by side in a :class:`MultiNetTables` (the
model axis padded to ``DEFAULT_MAX_M`` by repeating the last net, every
net on one shared layer bucket).

The port of the JAX package's ``core/multinet/joint_eval.py``.  That
package evaluates ``lax.map(vmap(row) ∘ vmap(model))`` in one compiled
program.  Here each **model lane** is one call of the single-model batch
path (``batch_eval.evaluate_batch``): lane m's B designs on model m's
tables, on one board per row (the lane's slice of the split, ``(B,)``
``DeviceTables``) in the spatial and hybrid modes and on the full board in
the temporal mode.  On the card that is one search-kernel launch per lane
and chunk.  The lanes cannot share one launch: the search kernel's pair
tables are per net.  The search's pair list is pruned for the full
board's PE count (slices never exceed it).

Padded lanes (models past the real ones) are returned in every
``per_model_*`` plane as in the JAX package: in the spatial and hybrid
modes a padded lane is its design on the FULL board, so it is evaluated
(once: every padded lane with the same design plane is a copy); in the
temporal mode it equals the last real lane, whose result it copies.

The three co-execution modes of :func:`joint_evaluate`:

* ``"spatial"``: M disjoint board slices, one accelerator each;
* ``"temporal"``: one full-board accelerator per model, weighted
  round-robin with per-round weight-reload (+ ``reconfig_s``) charges;
* ``"hybrid"``: a per-row (B, M) *assignment* gives each model either a
  dedicated spatial slice or membership in the row's single
  time-multiplexed shared slice.  An all-spatial assignment is the
  spatial mode bit for bit, an all-shared one the temporal mode.

System-level outputs per deployment row: ``agg_throughput_ips``,
``worst_latency_s``, ``min_model_throughput_ips``, ``fairness`` (Jain's
index over request-weight-normalized throughputs), ``slo_attainment``,
``traffic_bytes_per_s``; the per-model planes (``per_model_*``, each
(B, M)); and the repaired deployment actually evaluated (``pes_split``,
``buf_split``, ``bw_split``, ``time_share``, ``round_period_s``, and for
hybrid the canonical ``assign`` plane).  :func:`slo_attainment_dist`
grades the SLO check under per-model deadline distributions.

Under a sharded ``mesh`` (``core.shard.EvalMesh``) the deployment axis is
padded to a multiple of ``ndevices x tile`` and split across the mesh's
devices, the tables copied to each (:func:`_joint_sharded`); every shard
runs the same lanes on its rows, so the result is the single-device one
bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, DeviceTables,
                          NetTables, _seq_sum, evaluate_batch,
                          make_device_tables, make_tables, shared_max_L)
from ..device import DeviceSpec
from ..dse.encoding import MultiDesignBatch, pad_deployments, pad_plane
from ..workload import Network
from .partition import (DEFAULT_FLOORS, DEFAULT_MAX_M, gather_slices,
                        lane_devices, partition_devices,
                        repair_partition_torch, repair_time_shares_torch,
                        slice_masks, slice_shares)

F32 = torch.float32
NEG = -1.0e30

#: designs per block of a lane's batch-path call on the CPU (on the card a
#: block is the batch path's ``chunk``).  The JAX package's name for its
#: deployment tile; a lane here is one batch-path call, so it takes the
#: batch path's own CPU block.
JOINT_TILE = DEFAULT_TILE

#: per-model metrics the joint path reports as (B, M) planes
PER_MODEL_KEYS = ("latency_s", "throughput_ips", "buffer_bytes",
                  "access_bytes", "utilization", "n_ces")


# --------------------------------------------------------------------------
# per-model tables
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MultiNetTables:
    """M CNNs side by side: ``tables`` holds one ``NetTables`` per model
    lane (padded to ``max_m`` by repeating the last net, all on one layer
    bucket and one device), ``model_valid`` masks the real models.
    ``weights`` are normalized request rates, ``slo_s`` per-model latency
    SLOs (inf = none), ``weight_elems`` each lane's weight elements (the
    temporal modes' per-round reload), all (max_m,) f32 on the tables'
    device."""

    tables: tuple[NetTables, ...]
    model_valid: torch.Tensor
    weights: torch.Tensor
    slo_s: torch.Tensor
    weight_elems: torch.Tensor

    @property
    def max_m(self) -> int:
        """Padded model-axis length."""
        return len(self.tables)

    @property
    def n_models(self) -> int:
        """Number of real (unpadded) models."""
        return int(self.model_valid.sum().item())

    @property
    def device(self) -> torch.device:
        return self.model_valid.device

    @property
    def normalized_weights(self) -> np.ndarray:
        """The normalized per-model request weights the system metrics
        use, as a host (n_models,) array."""
        return self.weights.cpu().numpy()[:self.n_models]

    def n_layers(self, m: int) -> int:
        """Layer count of model m."""
        return self.tables[m].L


def _per_model_vector(x, m: int, name: str) -> np.ndarray:
    """Validate + broadcast a per-model parameter: a scalar broadcasts to
    all ``m`` models, a length-m sequence passes through; anything else is
    a shape error named after the parameter."""
    a = np.asarray(x, np.float64)
    if a.ndim == 0:
        a = np.full(m, float(a), np.float64)
    if a.shape != (m,):
        raise ValueError(f"{name} must be a scalar or have one entry per "
                         f"model (got shape {a.shape} for {m} models)")
    return a


def make_multi_tables(nets: list[Network], *, weights=None, slo_s=None,
                      max_m: int = DEFAULT_MAX_M, max_L: int | None = None,
                      device="cuda") -> MultiNetTables:
    """The per-model tables of a deployment, on ``device``.

    All models share one ``bucket_max_L`` layer bucket (a 200-layer net
    bumps every model to the next bucket).  The model axis pads by
    repeating the LAST net, matching ``dse.stack_designs``.

    ``weights`` (per-model request rates) and ``slo_s`` (per-model latency
    SLOs in seconds; ``inf`` = none) broadcast: a scalar applies to every
    model, a length-``len(nets)`` sequence is taken verbatim.  Weights
    must be finite, non-negative and not all zero (each condition has its
    own error); they are normalized to sum to 1
    (:attr:`MultiNetTables.normalized_weights`).  SLOs must be positive
    (``inf`` allowed, NaN rejected).
    """
    if not nets:
        raise ValueError("make_multi_tables needs at least one network")
    if len(nets) > max_m:
        raise ValueError(f"{len(nets)} models exceed max_m={max_m}; raise "
                         f"max_m")
    if max_L is None:
        max_L = shared_max_L(len(n) for n in nets)
    per = [make_tables(net, max_L=max_L, device=device) for net in nets]
    per = per + [per[-1]] * (max_m - len(per))

    m = len(nets)
    valid = np.zeros(max_m, np.float32)
    valid[:m] = 1.0
    w = np.ones(m, np.float64) if weights is None \
        else _per_model_vector(weights, m, "weights")
    if not np.isfinite(w).all():
        raise ValueError(f"weights must be finite, got {w.tolist()}")
    if (w < 0).any():
        raise ValueError(f"weights must be non-negative, got {w.tolist()}")
    if w.sum() <= 0:
        raise ValueError("weights must not be all zero — at least one "
                         "model needs a positive request rate")
    wfull = np.zeros(max_m, np.float32)
    wfull[:m] = (w / w.sum()).astype(np.float32)
    sfull = np.full(max_m, np.inf, np.float32)
    if slo_s is not None:
        s = _per_model_vector(slo_s, m, "slo_s")
        if np.isnan(s).any() or (s <= 0).any():
            raise ValueError(f"slo_s entries must be positive seconds "
                             f"(inf = no SLO), got {s.tolist()}")
        sfull[:m] = s
    # each lane's weight elements, summed on the host in float64 from its
    # f32 table and rounded once: the same bits on every device
    welems = np.array([np.sum((t.W * t.valid).cpu().numpy(), dtype=np.float64)
                       for t in per], np.float32)
    on = lambda a: torch.from_numpy(a).to(device)
    return MultiNetTables(tables=tuple(per), model_valid=on(valid),
                          weights=on(wfull), slo_s=on(sfull),
                          weight_elems=on(welems))


# --------------------------------------------------------------------------
# system metrics from per-model planes
# --------------------------------------------------------------------------
def _system_metrics(per: dict[str, torch.Tensor], mt: MultiNetTables
                    ) -> dict[str, torch.Tensor]:
    """Per-model (B, M) metric planes -> (B,) system metrics.  Sums over
    the model axis run left to right (the same bits on every device)."""
    valid = mt.model_valid[None, :]                       # (1, M)
    vmask = valid > 0
    nv = torch.clamp_min(_seq_sum(mt.model_valid), 1.0)
    tp = per["throughput_ips"]
    lat = per["latency_s"]
    acc = per["access_bytes"]

    agg_tp = _seq_sum(tp * valid)
    worst_lat = torch.where(vmask, lat, NEG).amax(-1)
    # request-weight-normalized service rates: Jain's index as the reported
    # fairness, the max-min rate as the (non-gameable) search objective.
    # Zero-weight (deployed but trafficless) models are excluded: they
    # would otherwise overflow the normalized rate.
    w = mt.weights[None, :]
    wpos = vmask & (w > 0)
    nw = torch.clamp_min(wpos.sum(-1).to(F32), 1.0)
    x = torch.where(wpos, tp / torch.clamp_min(w, 1e-30), 0.0)
    fairness = torch.square(_seq_sum(x)) / torch.clamp_min(
        nw * _seq_sum(torch.square(x)), 1e-30)
    # normalized so equal weights reduce to the plain min model throughput
    min_tp = torch.where(wpos, x, torch.inf).amin(-1) / nw
    slo_ok = torch.where(vmask, (lat <= mt.slo_s[None, :]).to(F32), 0.0)
    slo_att = _seq_sum(slo_ok) / nv
    traffic = _seq_sum(tp * acc * valid)
    return {
        "agg_throughput_ips": agg_tp,
        "worst_latency_s": worst_lat,
        "min_model_throughput_ips": min_tp,
        "fairness": fairness,
        "slo_attainment": slo_att,
        "traffic_bytes_per_s": traffic,
    }


def _package(per, mt):
    out = _system_metrics(per, mt)
    for k in PER_MODEL_KEYS:
        out[f"per_model_{k}"] = per[k]
    return out


# --------------------------------------------------------------------------
# the lanes: one batch-path call per model
# --------------------------------------------------------------------------
def _same_plane(md: MultiDesignBatch, a: int, b: int) -> bool:
    """Whether lanes a and b hold the same designs (a host sync)."""
    return all(torch.equal(x[:, a], x[:, b]) for x in (
        md.seg_end, md.seg_pipe, md.seg_nce, md.inter_pipe))


def _eval_lanes(md: MultiDesignBatch, mt: MultiNetTables, board_of, *,
                pad_copies_from: int, **kw) -> dict[str, torch.Tensor]:
    """Per-model (B, M) planes: lane m's designs through the batch path on
    ``board_of(m)``.  A padded lane whose design plane equals lane
    ``pad_copies_from``'s copies its result (same tables, same board),
    else it is evaluated."""
    outs: list[dict] = []
    for m in range(mt.max_m):
        if m > pad_copies_from and _same_plane(md, m, pad_copies_from):
            outs.append(outs[pad_copies_from])
            continue
        outs.append(evaluate_batch(md.model(m), mt.tables[m], board_of(m),
                                   **kw))
    return {k: torch.stack([o[k] for o in outs], 1) for k in PER_MODEL_KEYS}


def _eval_on_devices(md, mt, dev: DeviceTables, devs: DeviceTables, **kw):
    """The spatial and hybrid modes' lanes: real lane m on its per-row
    slices (lane m of ``devs``), padded lanes on the full board ``dev``
    (what ``partition_devices`` gives them)."""
    n = mt.n_models
    return _eval_lanes(
        md, mt, lambda m: lane_devices(devs, m) if m < n else dev,
        pad_copies_from=n, **kw)


def joint_spatial(md: MultiDesignBatch, mt: MultiNetTables,
                  dev: DeviceTables, pes_shares, buf_shares, bw_shares, *,
                  floors=DEFAULT_FLOORS, **kw) -> dict[str, torch.Tensor]:
    """The spatial mode: raw shares repaired into a valid split on the
    device, the board sliced into per-(row, model) boards, one batch-path
    call per lane.  ``kw`` goes to the batch path (``tile``, ``chunk``,
    ``fm_tile_rows``, ``full_pes``)."""
    part = repair_partition_torch(pes_shares, buf_shares, bw_shares, dev,
                                  mt.model_valid, floors=floors)
    devs = partition_devices(dev, part, mt.model_valid)   # leaves (B, M)
    res = _package(_eval_on_devices(md, mt, dev, devs, **kw), mt)
    res["pes_split"] = part.pes
    res["buf_split"] = part.buf
    res["bw_split"] = part.bw
    return res


def joint_temporal(md: MultiDesignBatch, mt: MultiNetTables,
                   dev: DeviceTables, time_shares, *,
                   share_floor: float = DEFAULT_FLOORS[2],
                   reconfig_s: float = 0.0, **kw) -> dict[str, torch.Tensor]:
    """Weighted round-robin time multiplexing: every model's design runs
    on the FULL board; model m holds the fabric for a ``w_m`` fraction of
    each round.

    When a model's slice starts, its weights re-stream from DDR, charging
    ``sw_m = weight_bytes_m / bps`` per round (plus ``reconfig_s``).  The
    shortest feasible round is ``T = max_m((lat_m + sw_m) / w_m)``; model
    m then sustains ``w_m * tp_m - sw_m * tp_m / T`` and its worst-case
    response time is ``(1 - w_m) * T + sw_m + lat_m``.  Padded lanes copy
    the last real lane (same design, tables and board)."""
    tsh = repair_time_shares_torch(time_shares, mt.model_valid,
                                   floor=share_floor)     # (B, M)
    per = _eval_lanes(md, mt, lambda m: dev,
                      pad_copies_from=mt.n_models - 1, **kw)

    vmask = mt.model_valid[None, :] > 0
    safe_w = torch.clamp_min(tsh, 1e-30)
    lat_full = per["latency_s"]
    w_bytes = mt.weight_elems * dev.wordbytes             # (M,)
    sw = (w_bytes / dev.bps + reconfig_s)[None, :]        # (1, M)
    T = torch.where(vmask, (lat_full + sw) / safe_w, NEG).amax(-1)  # (B,)
    per["throughput_ips"] = per["throughput_ips"] * torch.clamp_min(
        tsh - sw / T[:, None], 0.0)
    per["latency_s"] = torch.where(
        vmask, lat_full + sw + (1.0 - tsh) * T[:, None], lat_full)
    res = _package(per, mt)
    res["time_share"] = tsh
    res["round_period_s"] = T
    return res


def joint_hybrid(md: MultiDesignBatch, mt: MultiNetTables,
                 dev: DeviceTables, assign, pes_shares, buf_shares,
                 bw_shares, time_shares, *, floors=DEFAULT_FLOORS,
                 reconfig_s: float = 0.0, **kw) -> dict[str, torch.Tensor]:
    """Hybrid spatial+temporal deployments.

    ``assign`` (B, M) marks each model as a dedicated spatial slice owner
    (<= 0.5) or a member of the row's single time-multiplexed shared slice
    (> 0.5).  The board is split over *slices* (dedicated models + the
    shared slice, whose share pools its members' raw shares); every
    model's design is evaluated on its slice as in the spatial mode, and
    shared members are weighted-round-robin adjusted within their slice:
    per round the incoming model's weights re-stream over the slice's
    bandwidth (``sw_m = weight_bytes_m / slice_bps + reconfig_s``), the
    round is ``T = max_members((lat_m + sw_m) / w_m)``, member m sustains
    ``w_m·tp_m − sw_m·tp_m/T`` and responds in ``lat_m + sw_m + (1 −
    w_m)·T``: the temporal arithmetic, per slice.

    An all-spatial assignment equals :func:`joint_spatial` on the same
    shares bit for bit; an all-shared one equals :func:`joint_temporal`
    on the same time shares (the lone slice takes the board verbatim).
    """
    shared, slice_valid, slice_col = slice_masks(assign, mt.model_valid)
    part = repair_partition_torch(
        slice_shares(pes_shares, shared, slice_valid),
        slice_shares(buf_shares, shared, slice_valid),
        slice_shares(bw_shares, shared, slice_valid),
        dev, slice_valid, floors=floors)
    mpart = gather_slices(part, slice_col)                # per-model view
    devs = partition_devices(dev, mpart, mt.model_valid)  # leaves (B, M)
    per = _eval_on_devices(md, mt, dev, devs, **kw)

    # weighted round-robin within the shared slice (no-op for dedicated
    # models: their lanes keep the raw metrics bit for bit)
    tsh = repair_time_shares_torch(time_shares, shared, floor=floors[2])
    safe_w = torch.clamp_min(tsh, 1e-30)
    lat_full = per["latency_s"]
    w_bytes = mt.weight_elems * dev.wordbytes             # (M,)
    sw = w_bytes[None, :] / devs.bps + reconfig_s         # (B, M)
    T = torch.where(shared, (lat_full + sw) / safe_w, NEG).amax(-1)  # (B,)
    tp_rr = per["throughput_ips"] * torch.clamp_min(
        tsh - sw / T[:, None], 0.0)
    lat_rr = lat_full + sw + (1.0 - tsh) * T[:, None]
    per["throughput_ips"] = torch.where(shared, tp_rr,
                                        per["throughput_ips"])
    per["latency_s"] = torch.where(shared, lat_rr, lat_full)

    res = _package(per, mt)
    valid_f = (mt.model_valid > 0)[None, :].expand(shared.shape).to(F32)
    res["pes_split"] = mpart.pes
    res["buf_split"] = mpart.buf
    res["bw_split"] = mpart.bw
    res["time_share"] = torch.where(shared, tsh, valid_f)
    res["round_period_s"] = torch.where(shared.any(-1), T, 0.0)
    res["assign"] = shared.to(F32)
    return res


# --------------------------------------------------------------------------
# the public entry point
# --------------------------------------------------------------------------
def _joint_sharded(mesh, run, md: MultiDesignBatch, mt: MultiNetTables,
                   devt: DeviceTables, planes, *, tile: int):
    """Sharded joint evaluation: the deployment axis is padded to a
    multiple of ``ndevices x tile`` and sharded across the mesh, tables
    replicated, pad rows sliced back off: the multinet analogue of
    ``EvalMesh.evaluate_padded`` (the same row-local arithmetic, so it is
    bit-identical to the single-device call).  Each shard runs ``run``
    (a mode function), one batch-path call a model lane."""
    B = md.batch
    n = mesh.padded_rows(B, tile)
    out = mesh.shard_call(
        run, (pad_deployments(md, n), mt, devt,
              *(pad_plane(p, n) for p in planes)), replicated=(1, 2))
    return {k: v[:B] for k, v in out.items()}


def joint_evaluate(md: MultiDesignBatch, mt: MultiNetTables,
                   dev: DeviceSpec | DeviceTables, *, mode: str = "spatial",
                   pes_shares=None, buf_shares=None, bw_shares=None,
                   time_shares=None, assign=None, tile: int = JOINT_TILE,
                   chunk: int = DEFAULT_CHUNK, fm_tile_rows: int = 2,
                   floors=DEFAULT_FLOORS, reconfig_s: float = 0.0,
                   mesh=None) -> dict[str, torch.Tensor]:
    """Evaluate a batch of M-model deployments on the tables' device.

    ``mode="spatial"`` consumes raw (B, M) resource shares (repaired on the
    device; defaults to an equal split), ``mode="temporal"`` raw
    round-robin time shares, and ``mode="hybrid"`` a (B, M) ``assign``
    plane (> 0.5 = shared-slice member; defaults to all-spatial) plus both
    share families.  Shares and assignments are host arrays or tensors.
    ``dev`` is a board or its 0-d ``DeviceTables``.  Each lane is one
    batch-path call in blocks of ``chunk`` designs on the card (one
    search-kernel launch each) and ``tile`` on the CPU.  Returns metric
    tensors on the tables' device.  ``mesh`` (a ``core.shard.EvalMesh``,
    duck-typed) shards the deployment axis across its devices, the
    metrics landing on its first device; a None or single-device mesh
    takes the single-device path unchanged.
    """
    device = mt.device
    if isinstance(dev, DeviceSpec):
        full_pes = float(dev.pes)
        devt = make_device_tables(dev, device=device)
    else:
        if dev.per_row:
            raise ValueError("joint_evaluate takes one board (0-d "
                             "DeviceTables); the modes cut the slices")
        devt, full_pes = dev, float(dev.pes)
    md = md.to(device)
    B, max_m = md.batch, md.n_models
    if max_m != mt.max_m:
        raise ValueError(f"{max_m} design lanes for {mt.max_m} table lanes")
    ones = torch.ones((B, max_m), dtype=F32, device=device)
    plane = lambda a, default=ones: default if a is None \
        else torch.as_tensor(a, dtype=F32, device=device)
    kw = dict(tile=tile, chunk=chunk, fm_tile_rows=fm_tile_rows,
              full_pes=full_pes)
    if mode == "spatial":
        run = partial(joint_spatial, floors=tuple(floors), **kw)
        planes = (plane(pes_shares), plane(buf_shares), plane(bw_shares))
    elif mode == "temporal":
        run = partial(joint_temporal, share_floor=float(floors[2]),
                      reconfig_s=float(reconfig_s), **kw)
        planes = (plane(time_shares),)
    elif mode == "hybrid":
        run = partial(joint_hybrid, floors=tuple(floors),
                      reconfig_s=float(reconfig_s), **kw)
        planes = (plane(assign, torch.zeros_like(ones)), plane(pes_shares),
                  plane(buf_shares), plane(bw_shares), plane(time_shares))
    else:
        raise ValueError(f"unknown mode {mode!r}; known: spatial, "
                         f"temporal, hybrid")
    if mesh is not None and getattr(mesh, "is_sharded", False):
        return _joint_sharded(mesh, run, md, mt, devt, planes, tile=tile)
    return run(md, mt, devt, *planes)


# --------------------------------------------------------------------------
# SLO attainment under per-model deadline distributions
# --------------------------------------------------------------------------
#: default deadline grid: each model's ``slo_s`` is the central deadline of
#: a distribution of request deadlines sampled at these scale factors
DEADLINE_SCALES = (0.6, 0.8, 1.0, 1.25, 1.6)


def slo_attainment_dist(per_model_latency_s, mt: MultiNetTables, *,
                        scales=DEADLINE_SCALES) -> np.ndarray:
    """Host-side graded SLO attainment -> (B,) in [0, 1].

    Each model's deadline is sampled from its ``slo_s`` scaled by the
    ``scales`` grid; a deployment's attainment is the request-weighted
    fraction of sampled deadlines its per-model latencies meet:

    ``sum_m w_m * mean_s 1[lat_m <= scale_s * slo_m]``

    with ``w`` the normalized request weights.  Models with ``slo_s=inf``
    always attain.  ``per_model_latency_s`` is a (B, max_m) plane (array
    or tensor) or any prefix covering the real models.
    """
    if isinstance(per_model_latency_s, torch.Tensor):
        per_model_latency_s = per_model_latency_s.cpu().numpy()
    lat = np.asarray(per_model_latency_s, np.float64)     # (B, M)
    M = lat.shape[1]
    if M < mt.n_models:
        raise ValueError(f"latency plane covers {M} models; tables have "
                         f"{mt.n_models}")
    slo = mt.slo_s.cpu().numpy().astype(np.float64)[:M]   # (M,)
    w = (mt.weights.cpu().numpy().astype(np.float64)
         * mt.model_valid.cpu().numpy().astype(np.float64))[:M]
    wsum = w.sum()
    w = w / wsum if wsum > 0 else w
    sc = np.asarray(scales, np.float64)
    deadlines = slo[None, :, None] * sc[None, None, :]    # (1, M, S)
    met = lat[:, :, None] <= deadlines                    # (B, M, S)
    return (met.mean(-1) * w[None, :]).sum(-1)
