"""Drive the PyTorch port's MCCM paths on one NVIDIA card, and check them.

    python3 chip_smoke.py [--seed N] [--designs N]

Phases, each printing one JSON line:

1. card and build: the card, torch/CUDA versions, both TF32 flags (set
   False here: no matmul or convolution may run in TF32), and the ``nvcc``
   builds of the three kernels, started together, with their ptxas
   reports;
2. the search kernel against its plain PyTorch version on the card, on the
   baseline templates of every CNN x board, on 4096 ``sample_mixed`` rows
   of every CNN and on an all-infeasible batch: ⟨pf, ph, pw⟩ exactly equal,
   cost within rtol 1e-6 with inf where the plain version has inf;
3. the main path, ``Session(board).evaluate(specs, net)``, against the
   golden metrics the JAX package computed on the CPU
   (``src/repro_torch/data/golden_mccm.npz``): ``n_ces`` exact, the other
   metrics within rtol 1e-5;
4. realistic load: ResNet-50 on ZCU102 (paper Tab. I), a DesignBatch of
   ``--designs`` (default 100,000, the DSE budget) ``sample_mixed`` designs
   from ``--seed``: end-to-end µs per design, the kernel's and the plain
   version's ms per chunk, the kernel's bound, launches, peak memory and a
   profiler breakdown (written to ``chiprun_out/``);
5. the scalar path, ``Session(board).evaluate(spec, net)`` on every
   template of every CNN x board, against the golden scalar metrics the JAX
   package's Builder computed (exactly equal: both are the same Python
   arithmetic), and the batch path on the card against it within the JAX
   package's own scalar-vs-batch tolerances;
6. the Eq. 1 latency kernel at full width: the ⟨pf, ph, pw⟩ of each layer
   of the ``--designs`` designs of phase 4, as the batch path chooses them,
   through ``mccm_latency``: equal to its plain version and to the batch
   path's own cycles bit for bit, and to the scalar Builder's on the
   templates; ms, plain ms, bound, launches, peak memory;
7. the CE convolution kernel at full width: the 53 conv layers of
   ResNet-50 at their published widths (batch 1, unit-normal data from
   ``--seed``), each on its CE's ⟨pf, ph, pw⟩ in the port's Builder for
   every baseline arch with 11 CEs on ZCU102: the grid identity of Eq. 1
   exactly, the kernel equal to its plain version bit for bit and near
   ``conv2d``; ms per ResNet-50 pass beside ``conv2d``'s and the bound.

Then the ``kernels`` line, the card's name and power limit as
``nvidia-smi`` gives them, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
the last line.  Without a visible card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNELS = {
    "parallelism_search": dict(
        name="parallelism_search", route="cuda",
        source="src/repro_torch/kernels/mccm_eval/csrc/parallelism_search.cu",
        replaces="src/repro/kernels/mccm_eval/kernel.py:119"),
    "mccm_latency": dict(
        name="mccm_latency", route="cuda",
        source="src/repro_torch/kernels/mccm_eval/csrc/mccm_latency.cu",
        replaces="src/repro/kernels/mccm_eval/kernel.py:44"),
    "conv_ce": dict(
        name="conv_ce", route="cuda",
        source="src/repro_torch/kernels/conv_ce/csrc/conv_ce.cu",
        replaces="src/repro/kernels/conv_ce/kernel.py:66"),
}

#: device cycles of the sleep queued ahead of a timed run (~0.1 s)
SLEEP_CYCLES = 200_000_000

TEMPLATE_NS = (2, 5, 9, 11)
RTOL_KERNEL_COST = 1e-6
RTOL_METRICS = 1e-5
#: batch path (f32) against the scalar Builder (exact), the JAX package's
#: own tolerances (tests/test_batch_eval.py:15): f32 threshold flips move
#: access_bytes
RTOL_SCALAR = {"latency_s": 1e-4, "throughput_ips": 1e-4,
               "buffer_bytes": 1e-4, "access_bytes": 0.04}
#: mccm_latency against the scalar Builder's exact integer cycles: f32
#: rounds a product above 2**24 (three roundings per layer), and the
#: total adds 160 such values
RTOL_LAYER_CYCLES = 1e-6
RTOL_TOTAL_CYCLES = 1e-5
#: conv_ce against conv2d (cuDNN, TF32 off): the two add each output's
#: C*KH*KW terms (up to 4608) in different orders, so they part by a few
#: f32 ulps of the largest partial sums
RTOL_CONV = 1e-4
CONV_ARCH_CES = 11
OUT_DIR = os.path.join(ROOT, "chiprun_out")


class PhaseFailed(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, by CUDA events.  A
    device-side sleep is queued first, so that the host has enqueued the
    launches before the device reaches them and the events time the device,
    not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms_each(fns) -> list[float]:
    """Device ms of each of ``fns``, run once each back to back behind a
    device-side sleep, by a CUDA event between consecutive calls."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(fns) + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    events[0].record()
    for fn, ev in zip(fns, events[1:]):
        fn()
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------
def phase_build(card: str) -> dict:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.conv_ce import ops as conv_ops
    from repro_torch.kernels.mccm_eval import ops as mccm_ops
    loaders = {"parallelism_search": lambda: mccm_ops.library(
                   "parallelism_search"),
               "mccm_latency": lambda: mccm_ops.library("mccm_latency"),
               "conv_ce": conv_ops.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as ex:
        futs = {k: ex.submit(f) for k, f in loaders.items()}
        built = {k: f.result() for k, f in futs.items()}
    wall = time.perf_counter() - t0
    kernels = {}
    for name, b in built.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           b.ptxas)]
        if not regs:
            raise PhaseFailed(f"no ptxas report for the {name} kernel")
        kernels[name] = dict(
            build_s=b.seconds, library=os.path.relpath(b.path, ROOT),
            registers=regs, spill_store_bytes=[int(x) for x in re.findall(
                r"(\d+) bytes spill stores", b.ptxas)],
            ptxas=[ln.strip() for ln in b.ptxas.splitlines()
                   if "ptxas info" in ln and ("Used" in ln or "spill" in ln
                                              or "Compiling" in ln)])
    info = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0),
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                load_s=wall, kernels=kernels)
    emit("build", **info)
    return info


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------
def _search_inputs(net, dev, db, device):
    """The search's arguments as the main path builds them: each design's
    PEs and CE index per layer, then the network's and board's tables."""
    from repro_torch.core.batch_eval import (_ce_maps, _pair_layer_tables,
                                             _search_ce, make_device_tables,
                                             make_tables, pes_hint)
    from repro_torch.kernels.mccm_eval import pair_tables
    t = make_tables(net, device=device)
    m = _ce_maps(db.to(device), t, make_device_tables(dev, device=device))
    pairs = pair_tables(t.candidates, pes_hint(dev.pes))
    return (m.pes_ce, _search_ce(m), *_pair_layer_tables(t, pairs))


def _compare(args, label: str, worst: dict) -> None:
    import torch
    from repro_torch.kernels.mccm_eval import (parallelism_search,
                                               parallelism_search_ref)
    ker = parallelism_search(*args)
    ref = parallelism_search_ref(*args)
    torch.cuda.synchronize()
    for name, k, r in zip(("pf", "ph", "pw"), ker[:3], ref[:3]):
        if not torch.equal(k, r):
            n = int((k != r).sum())
            raise PhaseFailed(f"{label}: {name} differs in {n} entries")
    kc, rc = ker[3], ref[3]
    inf_k, inf_r = torch.isinf(kc), torch.isinf(rc)
    if not torch.equal(inf_k, inf_r):
        raise PhaseFailed(f"{label}: cost inf pattern differs")
    fin = ~inf_r
    diff = (kc[fin] - rc[fin]).abs()
    rel = diff / rc[fin].abs().clamp_min(1.0)
    if fin.any():
        worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
        worst["max_rel_err"] = max(worst["max_rel_err"], float(rel.max()))
        if float(rel.max()) > RTOL_KERNEL_COST:
            raise PhaseFailed(f"{label}: cost rel err {float(rel.max())}")
    worst["cases"] += 1
    worst["designs"] += kc.shape[0]


def phase_kernel(card: str, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.cnn.registry import CNN_NAMES, get_cnn
    from repro_torch.core.dse import encode_specs, sample_mixed
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES, get_board
    from repro_torch.kernels.mccm_eval import parallelism_search

    worst = dict(max_abs_err=0.0, max_rel_err=0.0, cases=0, designs=0)
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        tmpl = encode_specs([make_arch(a, net, n) for a in ARCH_NAMES
                             for n in TEMPLATE_NS], len(net))
        for board in BOARD_NAMES:
            _compare(_search_inputs(net, get_board(board), tmpl, device),
                     f"{cnn}/{board}/templates", worst)
        mixed = sample_mixed(np.random.default_rng(1), len(net), 4096)
        _compare(_search_inputs(net, get_board("zcu102"), mixed, device),
                 f"{cnn}/zcu102/mixed4096", worst)
    # all-infeasible: CEs with 0 PEs and no layers -> <1, 1, 1> at inf
    args = list(_search_inputs(get_cnn("mobilenetv2"), get_board("zc706"),
                               encode_specs([make_arch("hybrid",
                                                       get_cnn("mobilenetv2"),
                                                       2)], 52), device))
    B, L = 3, args[1].shape[1]
    args[0] = torch.zeros(B, 16, device=device)
    args[1] = torch.full((B, L), -1, dtype=torch.int32, device=device)
    _compare(tuple(args), "all-infeasible", worst)
    pf, ph, pw, cost = parallelism_search(*args)
    if not (bool((pf == 1).all()) and bool((ph == 1).all())
            and bool((pw == 1).all()) and bool(torch.isinf(cost).all())):
        raise PhaseFailed("all-infeasible CEs did not give <1, 1, 1, inf>")
    emit("kernel_vs_plain", card=card, kernel="parallelism_search",
         replaces=KERNELS["parallelism_search"]["replaces"],
         rtol_cost=RTOL_KERNEL_COST, **worst)
    return worst


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------
def _check_metrics(got: dict, golden, prefix: str, worst: dict) -> None:
    import numpy as np
    for k, g in got.items():
        want = golden[f"{prefix}/{k}"]
        g = np.asarray(g)
        if k == "n_ces":
            if not np.array_equal(g, want):
                raise PhaseFailed(f"{prefix}: n_ces differs")
            continue
        if not np.isfinite(g).all():
            raise PhaseFailed(f"{prefix}: non-finite {k}")
        rel = float((np.abs(g - want) / np.maximum(np.abs(want), 1e-30)
                     ).max())
        worst[k] = max(worst.get(k, 0.0), rel)
        if rel > RTOL_METRICS:
            raise PhaseFailed(f"{prefix}: {k} rel err {rel} > "
                              f"{RTOL_METRICS}")


def phase_main_vs_golden(card: str, device) -> dict:
    import numpy as np
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.core.dse import decode_batch, sample_mixed
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES
    from repro_torch.kernels.mccm_eval import launches, reset_launches

    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_mccm.npz"))
    worst: dict = {}
    sessions = {b: Session(get_board(b), device=str(device))
                for b in BOARD_NAMES}
    reset_launches()
    rows = 0
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        for board, ses in sessions.items():
            _check_metrics(ses.evaluate(specs, net), golden,
                           f"tmpl/{cnn}/{board}", worst)
            rows += len(specs)
    net = get_cnn("resnet50")
    mixed = decode_batch(sample_mixed(np.random.default_rng(0), len(net),
                                      256), len(net))
    _check_metrics(sessions["zcu102"].evaluate(mixed, net), golden,
                   "mixed/resnet50/zcu102", worst)
    rows += len(mixed)
    n = launches()
    emit("main_vs_golden", card=card, rows=rows, launches=n,
         rtol=RTOL_METRICS, max_rel_err=worst)
    if n["parallelism_search"] == 0:
        raise PhaseFailed("the main path launched no search kernel")
    return worst


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------
def phase_load(card: str, device, seed: int, n_designs: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.core.batch_eval import DEFAULT_CHUNK
    from repro_torch.core.dse import sample_mixed
    from repro_torch.kernels.mccm_eval import (launches,
                                               parallelism_search,
                                               parallelism_search_ref,
                                               reset_launches)

    net, board = get_cnn("resnet50"), get_board("zcu102")
    batch = sample_mixed(np.random.default_rng(seed), len(net), n_designs)
    ses = Session(board, device=str(device))
    ses.evaluate(batch, net)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = ses.evaluate(batch, net)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_launch = launches()["parallelism_search"]
    peak = torch.cuda.max_memory_allocated(device)
    if n_launch == 0:
        raise PhaseFailed("the main path launched no search kernel")
    for k, v in out.items():
        if v.shape[0] != n_designs or not bool(torch.isfinite(
                v.to(torch.float32)).all()):
            raise PhaseFailed(f"load: {k} has shape {tuple(v.shape)} or "
                              f"non-finite values")

    # the kernel alone, at one chunk of this batch
    args = _search_inputs(net, board, batch.take(slice(0, DEFAULT_CHUNK)),
                          device)
    kernel_ms = cuda_ms(lambda: parallelism_search(*args), 50)
    plain_ms = cuda_ms(lambda: parallelism_search_ref(*args), 3)
    # bound: every input read once (all 4-byte words), the four (B, NC)
    # outputs written once, and 5 f32 operations per pair for each layer
    # that maps to a CE (this chunk's count, not the padded L)
    pes, ce_idx, fc = args[:3]
    B, L, P = ce_idx.shape[0], fc.shape[0], fc.shape[1]
    live_layers = int((ce_idx >= 0).sum())
    in_bytes = 4 * sum(a.numel() for a in args)
    out_bytes = 4 * 4 * B * 16
    ops = 5 * P * live_layers
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    kernel = dict(
        **KERNELS["parallelism_search"], chunk_designs=B, layers_padded=L, pairs=P,
        live_layers=live_layers, bytes=in_bytes + out_bytes, ops=ops,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, launches=n_launch)
    breakdown = _profile(ses, batch, net, statistics.median(walls))
    info = dict(card=card, cnn="resnet50", board="zcu102", seed=seed,
                designs=n_designs, wall_s=walls,
                us_per_design=[w / n_designs * 1e6 for w in walls],
                us_per_design_median=statistics.median(walls)
                / n_designs * 1e6,
                launches=n_launch, runs=len(walls),
                max_memory_allocated=peak, kernel=kernel,
                profile=breakdown)
    emit("load", **info)
    return kernel


def _profile(ses, batch, net, wall_unprofiled: float) -> dict:
    """Device time over one evaluate, from torch.profiler: busy time as the
    sum of the kernels' device times (one stream, so they do not overlap),
    the PyTorch ops that launched the most of it, and the full table in
    chiprun_out/profile_load.txt.  The idle share is taken against
    ``wall_unprofiled``, the median wall of the same evaluate without the
    profiler, whose own overhead stretches the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ses.evaluate(batch, net)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    ops = [e for e in rows if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_load.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=60))
    if busy_s == 0:
        return {"device_time": "not measured", "wall_s_profiled": wall}
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    search = [e for e in kernels if "parallelism_search" in e.key]
    return {"wall_s_profiled": wall, "wall_s_unprofiled": wall_unprofiled,
            "device_busy_s": busy_s,
            "device_idle_share": max(0.0, 1 - busy_s / wall_unprofiled),
            "device_idle_share_profiled": max(0.0, 1 - busy_s / wall),
            "kernel_launches": sum(e.count for e in kernels),
            "search_kernel_s": sum(e.self_device_time_total
                                   for e in search) / 1e6,
            "top_ops": [{"op": e.key, "self_device_ms":
                         e.self_device_time_total / 1e3, "calls": e.count}
                        for e in top]}


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------
def _scalar_rows(metrics, fields) -> dict:
    """Scalar Metrics as the golden file keeps them: a float64 array per
    field, and ce_busy_s as (rows, 16) by CE id with NaN for no CE."""
    import numpy as np
    out = {k: np.array([float(getattr(m, k)) for m in metrics], np.float64)
           for k in fields if k != "ce_busy_s"}
    busy = np.full((len(metrics), 16), np.nan)
    for i, m in enumerate(metrics):
        for ce, b in m.ce_busy_s.items():
            busy[i, ce] = b
    out["ce_busy_s"] = busy
    return out


def phase_scalar(card: str, device) -> dict:
    import numpy as np
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.cnn.registry import CNN_NAMES
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.fpga.boards import BOARD_NAMES
    from repro_torch.kernels import launches, reset_launches

    golden = np.load(os.path.join(ROOT, "src", "repro_torch", "data",
                                  "golden_mccm.npz"))
    worst = {k: 0.0 for k in RTOL_SCALAR}
    parted: list[dict] = []
    designs = 0
    wall = 0.0
    reset_launches()
    for cnn in CNN_NAMES:
        net = get_cnn(cnn)
        specs = [make_arch(a, net, n) for a in ARCH_NAMES
                 for n in TEMPLATE_NS]
        for board in BOARD_NAMES:
            ses = Session(get_board(board), device=str(device))
            prefix = f"scalar/{cnn}/{board}/"
            fields = [k[len(prefix):] for k in golden.files
                      if k.startswith(prefix)]
            t0 = time.perf_counter()
            ms = [ses.evaluate(s, net) for s in specs]
            wall += time.perf_counter() - t0
            got = _scalar_rows(ms, fields)
            if sorted(got) != sorted(fields):
                raise PhaseFailed(f"{prefix}: golden fields {fields}")
            for k, g in got.items():
                if not np.array_equal(g, golden[prefix + k],
                                      equal_nan=True):
                    raise PhaseFailed(f"{prefix}{k} differs from the "
                                      f"golden scalar metrics")
            batch = ses.evaluate(specs, net)           # on the card
            for k, tol in RTOL_SCALAR.items():
                rel = np.abs(batch[k] - got[k]) / np.abs(got[k])
                # rows where the JAX package's own batch path and Builder
                # part (the golden file holds both): phase 3 holds the
                # card's batch to the reference's batch there instead
                want = golden[f"tmpl/{cnn}/{board}/{k}"]
                ref_rel = np.abs(want - got[k]) / np.abs(got[k])
                for i in np.nonzero(ref_rel > tol)[0]:
                    parted.append(dict(cnn=cnn, board=board,
                                       design=specs[i].name, metric=k,
                                       reference_rel=float(ref_rel[i]),
                                       port_rel=float(rel[i])))
                rel = float(np.where(ref_rel > tol, 0.0, rel).max())
                worst[k] = max(worst[k], rel)
                if rel > tol:
                    raise PhaseFailed(f"{cnn}/{board}: batch {k} is {rel} "
                                      f"from the scalar Builder (> {tol})")
            designs += len(specs)
    n = launches()
    emit("scalar_path", card=card, designs=designs, scalar_s=wall,
         scalar_ms_per_design=wall / designs * 1e3, golden="exact",
         batch_vs_scalar_rtol=RTOL_SCALAR, batch_vs_scalar_max_rel=worst,
         reference_batch_parts_from_scalar=parted, launches=n)
    if n["parallelism_search"] == 0:
        raise PhaseFailed("the batch path launched no search kernel")
    return worst


# --------------------------------------------------------------------------
# phase 6
# --------------------------------------------------------------------------
def _layer_par(db, t, dt, search):
    """The per-layer ⟨pf, ph, pw⟩ (B, L, 3) that the batch path chooses
    for ``db``, chunk by chunk as ``evaluate_batch`` runs it, masked to 1
    off the valid layers as ``layer_state`` does; and ``layer_state``'s
    own (B, L) cycles for the same choice."""
    import torch
    from repro_torch.core.batch_eval import (DEFAULT_CHUNK, _ce_maps,
                                             _per_layer, _search_ce,
                                             layer_state)
    from repro_torch.kernels.mccm_eval import parallelism_search
    pars, comps = [], []
    for s in range(0, db.batch, DEFAULT_CHUNK):
        chunk = db.take(slice(s, s + DEFAULT_CHUNK))
        m = _ce_maps(chunk, t, dt)
        pf, ph, pw, _ = parallelism_search(m.pes_ce, _search_ce(m), *search)
        pars.append(torch.stack(
            [torch.where(m.valid_b, _per_layer(x, m), 1.0)
             for x in (pf, ph, pw)], -1))
        comps.append(layer_state(chunk, t, dt, m, (pf, ph, pw), 2).comp)
    return torch.cat(pars), torch.cat(comps)


def phase_latency(card: str, device, seed: int, n_designs: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.core.batch_eval import (_pair_layer_tables,
                                             make_device_tables,
                                             make_tables, pes_hint)
    from repro_torch.core.blocks import layer_cycles
    from repro_torch.core.dse import encode_specs, sample_mixed
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.mccm_eval import (mccm_latency,
                                               mccm_latency_ref,
                                               pair_tables)

    net, board = get_cnn("resnet50"), get_board("zcu102")
    t = make_tables(net, device=device)
    dt = make_device_tables(board, device=device)
    search = _pair_layer_tables(t, pair_tables(t.candidates,
                                               pes_hint(board.pes)))
    dims = torch.stack([t.F, t.CKK, t.OH, t.OW], 1)        # (L, 4)
    db = sample_mixed(np.random.default_rng(seed), len(net),
                      n_designs).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    par, comp = _layer_par(db, t, dt, search)
    tot, cyc = mccm_latency(dims, par)
    torch.cuda.synchronize()
    n = launches()
    peak = torch.cuda.max_memory_allocated(device)
    if n["mccm_latency"] == 0:
        raise PhaseFailed("the latency path launched no mccm_latency kernel")

    ref_tot, ref_cyc = mccm_latency_ref(dims, par)
    torch.cuda.synchronize()
    if not (torch.equal(tot, ref_tot) and torch.equal(cyc, ref_cyc)):
        raise PhaseFailed(
            f"mccm_latency differs from its plain version: "
            f"{int((tot != ref_tot).sum())} totals, "
            f"{int((cyc != ref_cyc).sum())} cycles")
    if not torch.equal(cyc, comp):
        raise PhaseFailed(f"mccm_latency differs from layer_state's comp in "
                          f"{int((cyc != comp).sum())} entries")
    max_abs_err = max(float((tot - ref_tot).abs().max()),
                      float((cyc - ref_cyc).abs().max()))

    # the 12 templates against the scalar Builder's exact cycles
    ses = Session(board, device=str(device))
    specs = [make_arch(a, net, n_) for a in ARCH_NAMES for n_ in TEMPLATE_NS]
    tpar, _ = _layer_par(encode_specs(specs, len(net), device=device), t, dt,
                         search)
    ttot, tcyc = mccm_latency(dims, tpar)
    tcyc, ttot = tcyc.cpu().numpy(), ttot.cpu().numpy()
    worst_layer = worst_total = 0.0
    for i, spec in enumerate(specs):
        acc = ses.build(spec, net)
        want = np.zeros(len(net))
        for seg in acc.segments:
            for k, li in enumerate(range(seg.spec.layer_lo,
                                         seg.spec.layer_hi + 1)):
                want[li] = layer_cycles(net[li], seg.ces[k % len(seg.ces)])
        worst_layer = max(worst_layer, float(
            (np.abs(tcyc[i, :len(net)] - want) / want).max()))
        worst_total = max(worst_total, abs(ttot[i] - want.sum())
                          / want.sum())
    if worst_layer > RTOL_LAYER_CYCLES or worst_total > RTOL_TOTAL_CYCLES:
        raise PhaseFailed(f"mccm_latency vs the scalar Builder: layer rel "
                          f"{worst_layer}, total rel {worst_total}")

    kernel_ms = cuda_ms(lambda: mccm_latency(dims, par), 20)
    plain_ms = cuda_ms(lambda: mccm_latency_ref(dims, par), 3)
    B, L = par.shape[0], dims.shape[0]
    nbytes = 4 * (dims.numel() + par.numel() + B + B * L)
    ops = 10 * B * L        # 3 divisions, 3 ceils, 3 products, 1 add
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    kernel = dict(
        **KERNELS["mccm_latency"], designs=B, layers_padded=L,
        bytes=nbytes, ops=ops, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, launches=n["mccm_latency"],
        max_abs_err=max_abs_err)
    emit("latency", card=card, cnn="resnet50", board="zcu102", seed=seed,
         launches=n, max_memory_allocated=peak, equal_plain=True,
         equal_layer_state=True, template_layer_max_rel=worst_layer,
         template_total_max_rel=worst_total, kernel=kernel)
    return kernel


# --------------------------------------------------------------------------
# phase 7
# --------------------------------------------------------------------------
def _conv_layers(net, seed: int, device):
    """Each conv layer's 'same'-padded IFM and its weights, unit-normal f32
    from ``seed`` by numpy, on the card.  conv_ce is valid-only, so the
    IFM is padded here: total max((OH-1)*s + K - I, 0), half (rounded
    down) on top and left."""
    import numpy as np
    import torch
    import torch.nn.functional as nnf
    rng = np.random.default_rng(seed)
    out = []
    for l in net:
        x = torch.from_numpy(rng.standard_normal(
            (l.in_ch, l.ih, l.iw), dtype=np.float32)).to(device)
        w = torch.from_numpy(rng.standard_normal(
            (l.out_ch, l.in_ch, l.kh, l.kw), dtype=np.float32)).to(device)
        ph = max((l.oh - 1) * l.stride + l.kh - l.ih, 0)
        pw = max((l.ow - 1) * l.stride + l.kw - l.iw, 0)
        x = nnf.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        out.append((x, w))
    return out


def _ce_tiles(ses, spec, net):
    """⟨pf, ph, pw⟩ and the CE of every layer in the Builder's design."""
    acc = ses.build(spec, net)
    tiles = [None] * len(net)
    for seg in acc.segments:
        for k, li in enumerate(range(seg.spec.layer_lo,
                                     seg.spec.layer_hi + 1)):
            ce = seg.ces[k % len(seg.ces)]
            tiles[li] = (ce, (ce.par_of("f"), ce.par_of("oh"),
                              ce.par_of("ow")))
    return tiles


def phase_conv(card: str, device, seed: int) -> dict:
    import statistics as stats
    import torch
    import torch.nn.functional as nnf
    from repro_torch.api import Session, get_board, get_cnn
    from repro_torch.core.blocks import layer_cycles
    from repro_torch.fpga.archs import ARCH_NAMES, make_arch
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.conv_ce import conv_ce, conv_ref, grid_size

    net = get_cnn("resnet50")
    if any(l.kind == "dw" for l in net):
        raise PhaseFailed("the conv phase expects no depthwise layer")
    ses = Session(get_board("zcu102"), device=str(device))
    data = _conv_layers(net, seed, device)
    designs = {a: _ce_tiles(ses, make_arch(a, net, CONV_ARCH_CES), net)
               for a in ARCH_NAMES}
    for a, tiles in designs.items():
        for l, (ce, par) in zip(net, tiles):
            ckk = l.in_ch * l.kh * l.kw
            if grid_size(l.out_ch, l.oh, l.ow, *par) * ckk != \
                    layer_cycles(l, ce):
                raise PhaseFailed(f"{a}/{l.name}: grid x C*KH*KW is not "
                                  f"Eq. 1")

    def run(tiles):
        return [conv_ce(x, w, stride=l.stride, par_f=par[0],
                        par_oh=par[1], par_ow=par[2])
                for l, (x, w), (_, par) in zip(net, data, tiles)]

    torch.cuda.synchronize()
    reset_launches()
    outs = {a: run(tiles) for a, tiles in designs.items()}
    torch.cuda.synchronize()
    n = launches()
    if n["conv_ce"] != len(designs) * len(net):
        raise PhaseFailed(f"conv_ce launched {n['conv_ce']} times, not "
                          f"{len(designs) * len(net)}")

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = [conv_ref(x, w, l.stride) for l, (x, w) in zip(net, data)]
    stop.record()
    torch.cuda.synchronize()
    plain_pass_ms = start.elapsed_time(stop)
    lib = [nnf.conv2d(x[None], w, stride=l.stride)[0]
           for l, (x, w) in zip(net, data)]
    max_abs_err = 0.0
    worst_lib = 0.0
    for a, got in outs.items():
        for l, g, r, lr in zip(net, got, plain, lib):
            if g.shape != (l.out_ch, l.oh, l.ow):
                raise PhaseFailed(f"{a}/{l.name}: shape {tuple(g.shape)}")
            if not torch.equal(g, r):
                raise PhaseFailed(
                    f"{a}/{l.name}: conv_ce differs from its plain version "
                    f"in {int((g != r).sum())} of {g.numel()} outputs")
            max_abs_err = max(max_abs_err, float((g - r).abs().max()))
            scale = float(lr.abs().max())
            excess = float(((g - lr).abs() - RTOL_CONV * lr.abs()).max())
            worst_lib = max(worst_lib, excess / scale)
            if excess > RTOL_CONV * scale:
                raise PhaseFailed(f"{a}/{l.name}: conv_ce is further from "
                                  f"conv2d than rtol {RTOL_CONV}, atol "
                                  f"{RTOL_CONV}*max|conv2d|")

    pass_ms = {a: cuda_ms(lambda t=tiles: run(t), 5)
               for a, tiles in designs.items()}
    # where a pass's time goes: the slowest layers of each design, with
    # the grid's blocks and the outputs a full tile holds
    slowest = {}
    for a, tiles in designs.items():
        each = cuda_ms_each([
            lambda l=l, x=x, w=w, par=par: conv_ce(
                x, w, stride=l.stride, par_f=par[0], par_oh=par[1],
                par_ow=par[2])
            for l, (x, w), (_, par) in zip(net, data, tiles)])
        top = sorted(range(len(net)), key=lambda i: -each[i])[:5]
        slowest[a] = [dict(
            layer=net[i].name, ms=each[i], tile=tiles[i][1],
            blocks=grid_size(net[i].out_ch, net[i].oh, net[i].ow,
                             *tiles[i][1]),
            ckk=net[i].in_ch * net[i].kh * net[i].kw) for i in top]
    library_ms = cuda_ms(lambda: [nnf.conv2d(x[None], w, stride=l.stride)
                                  for l, (x, w) in zip(net, data)], 5)
    big = max(range(len(net)), key=lambda i: net[i].in_ch * net[i].kh
              * net[i].kw)
    x, w = data[big]
    plain_big_ms = cuda_ms(lambda: conv_ref(x, w, net[big].stride), 1)
    # bound: 2 operations a MAC; each padded input, weight and output once
    flops = 2 * sum(l.macs for l in net)
    nbytes = 4 * sum(x.numel() + w.numel() + l.out_ch * l.oh * l.ow
                     for l, (x, w) in zip(net, data))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_OPS_PER_S * 1e3
    kernel = dict(
        **KERNELS["conv_ce"], layers=len(net), designs=list(designs),
        flops=flops, bytes=nbytes,
        ms=stats.mean(pass_ms.values()), plain_ms=plain_pass_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms, launches=n["conv_ce"],
        max_abs_err=max_abs_err)
    emit("conv", card=card, cnn="resnet50", board="zcu102", seed=seed,
         ces=CONV_ARCH_CES, layer_runs=len(designs) * len(net),
         launches=n, grid_is_eq1=True, equal_plain=True,
         vs_conv2d=dict(rtol=RTOL_CONV, atol_of_max=RTOL_CONV,
                        worst_excess_of_max=worst_lib),
         pass_ms=pass_ms, slowest_layers=slowest,
         conv2d_pass_ms=library_ms,
         plain_pass_ms=plain_pass_ms,
         plain_one_layer=dict(layer=net[big].name, ms=plain_big_ms),
         kernel=kernel)
    return kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--designs", type=int, default=100_000)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = nvidia_smi()

    phase_build(card)
    err = phase_kernel(card, device)
    phase_main_vs_golden(card, device)
    search = phase_load(card, device, args.seed, args.designs)
    search["max_abs_err"] = err["max_abs_err"]
    phase_scalar(card, device)
    latency = phase_latency(card, device, args.seed, args.designs)
    conv = phase_conv(card, device, args.seed)
    lost = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")]
    if lost:
        raise PhaseFailed(f"imported {lost}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernel[k] for k in keys}
                                  for kernel in (search, latency, conv)]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
