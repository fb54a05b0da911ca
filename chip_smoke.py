"""Drive the PyTorch port's MCCM batch path on one NVIDIA card, and check it.

    python3 chip_smoke.py [--seed N] [--designs N]

Phases, each printing one JSON line:

1. card and build: the card, torch/CUDA versions, both TF32 flags (set
   False here: no matmul may run in TF32), and the ``nvcc`` build of the
   search kernel with its ptxas report;
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
   profiler breakdown (written to ``chiprun_out/``).

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

KERNEL = dict(
    name="parallelism_search",
    route="cuda",
    source="src/repro_torch/kernels/mccm_eval/csrc/parallelism_search.cu",
    replaces="src/repro/kernels/mccm_eval/kernel.py:119")

#: device cycles of the sleep queued ahead of a timed run (~0.1 s)
SLEEP_CYCLES = 200_000_000

TEMPLATE_NS = (2, 5, 9, 11)
RTOL_KERNEL_COST = 1e-6
RTOL_METRICS = 1e-5
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


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------
def phase_build(card: str) -> dict:
    import torch
    from repro_torch.kernels.mccm_eval.ops import library
    t0 = time.perf_counter()
    built = library()
    wall = time.perf_counter() - t0
    report = [ln.strip() for ln in built.ptxas.splitlines()
              if "ptxas info" in ln and ("Used" in ln or "spill" in ln
                                         or "Compiling" in ln)]
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", built.ptxas)]
    spills = [int(x) for x in
              re.findall(r"(\d+) bytes spill stores", built.ptxas)]
    info = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0),
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                build_s=built.seconds, load_s=wall,
                library=os.path.relpath(built.path, ROOT),
                registers=regs, spill_store_bytes=spills, ptxas=report)
    emit("build", **info)
    if not regs:
        raise PhaseFailed("no ptxas report for the kernel")
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
    emit("kernel_vs_plain", card=card, kernel=KERNEL["name"],
         replaces=KERNEL["replaces"], rtol_cost=RTOL_KERNEL_COST, **worst)
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
        **KERNEL, chunk_designs=B, layers_padded=L, pairs=P,
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
    kernel = phase_load(card, device, args.seed, args.designs)
    lost = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")]
    if lost:
        raise PhaseFailed(f"imported {lost}")
    keys = ("name", "route", "source", "replaces", "launches", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {k: kernel[k] for k in keys}
    line["max_abs_err"] = err["max_abs_err"]
    print(json.dumps({"kernels": [line]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
