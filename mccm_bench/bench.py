"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the result line.

The traffic is a closed loop with one caller and no think time: each call
evaluates one batch of the mix's pool (drawn from the seed at set-up and
used in turn) and ends with the metrics on the host.  The window runs
calls until ``seconds`` have passed.  The harness only gathers readings
(``ctx`` in ``run``); each metric's reader in ``metrics/`` turns them
into its number.
"""
from __future__ import annotations

import gc
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import cells, check, profile, traffic
from .reference import Reference
from .system import System, well_formed

#: top-level module names that may not be loaded in a run: the JAX
#: package the program was ported from, and JAX itself
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list[str]:
    """The forbidden top-level names ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN_MODULES)


def _power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def window(system, pool, seconds: float, rng, rows_per_call: int,
           names) -> dict:
    """The closed loop: calls in turn over the pool until ``seconds`` have
    passed.  Returns the calls' walls and enqueue times, the failures, the
    kept rows and the window's length."""
    n = len(pool[0][0])
    designs = [system.designs(b) for b in pool]
    walls, enqueue, records, errors = [], [], [], []
    attempted = failed = 0
    t_start = time.perf_counter()
    while attempted == 0 or time.perf_counter() - t_start < seconds:
        k = attempted % len(pool)
        attempted += 1
        t0 = time.perf_counter()
        try:
            out, t_enq = system.call(designs[k])
        except Exception as e:  # noqa: BLE001 — a failed call is counted
            walls.append(time.perf_counter() - t0)
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
            continue
        walls.append(time.perf_counter() - t0)
        enqueue.append(t_enq)
        if not well_formed(out, n, names):
            failed += 1
            errors.append("missing, misshapen or non-finite metrics")
            continue
        rows = check.sample_rows(rng, n, rows_per_call)
        records.append((k, rows, {m: out[m][rows] for m in names}))
    return dict(walls=walls, enqueue=enqueue, records=records,
                attempted=attempted, failed=failed, errors=errors,
                window_s=time.perf_counter() - t_start,
                designs=(attempted - failed) * n)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None,
        mix_override: dict | None = None) -> dict:
    """Run a cell and return ``result`` (the result line's object),
    ``detail`` (what else is worth keeping) and ``check_lines``."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cells.load_spec()
    cell = cells.find_cell(spec, cell_name)
    cfg = cells.load_config(spec, cell)
    mix = {**cells.load_mix(cell["traffic"]), **(mix_override or {})}
    readers = cells.readers(spec, cell_name, trace)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"imports_s": time.perf_counter() - t_start}

    # ---- set-up -------------------------------------------------------
    t0 = time.perf_counter()
    system = System(cfg, mix, device)
    phases["session_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = traffic.design_pool(mix, len(cfg["network"]["layers"]), seed)
    phases["pool_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(mix["warmup_calls"]):
        system.call(system.designs(pool[i % len(pool)]))
    sync()
    phases["warmup_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start

    # ---- the window ---------------------------------------------------
    w = window(system, pool, seconds, traffic.seed_rng(seed, 1),
               mix["check_rows_per_call"], check.METRICS)
    prof, order = None, []
    if trace:
        designs = [system.designs(b) for b in pool]
        order = [i % len(pool) for i in range(mix["trace_calls"])]

        def traced(i, mark):
            with mark("bench.call"):
                out, _ = system.call(designs[order[i]], mark)
                with mark("bench.check"):
                    well_formed(out, len(pool[0][0]), check.METRICS)
        prof = profile.profile_calls(traced, len(order), sync)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the comparison -----------------------------------------------
    t0 = time.perf_counter()
    ref = Reference(cfg, device)
    readings = {"failed_calls": w["failed"], "max_rel_gap": float("inf")}
    where = {}
    if w["records"]:
        want = check.reference_rows(w["records"], pool, ref)
        readings["max_rel_gap"], where = check.widest_gap(w["records"], want)
    correct = check.verdict(readings)
    ref_s = time.perf_counter() - t0

    # ---- the metrics ----------------------------------------------------
    # what a reader may read: each call's seconds (host clock, entering
    # ``evaluate`` to the metrics on the host) and its seconds inside
    # ``evaluate``, the window's length and designs, the set-up's seconds,
    # the traced calls' profile and their pool indices, the pool, and the
    # reference (for a yardstick's count of the traced work)
    ctx = {"walls_s": w["walls"], "enqueue_s": w["enqueue"],
           "window_s": w["window_s"], "designs": w["designs"],
           "setup_s": setup_s, "profile": prof, "trace_order": order,
           "pool": pool, "reference": ref}
    metrics = {}
    for m, read in readers:
        v = read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if cuda else torch.device(device).type,
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w["attempted"],
              "failed": w["failed"], "metrics": metrics, "device": dev_info}
    if trace and prof is not None and "busy_s" in prof:
        dev_info["busy_s"] = prof["busy_s"]
        dev_info["window_s"] = prof["wall_s"]
        result["breakdown"] = {
            "device_ops": profile.top({k: v[1] for k, v
                                       in prof["by_kernel"].items()}),
            "idle_gaps": profile.top(prof["idle_gaps"])}
    result["checks"] = {k: {"value": readings[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    detail = {
        "cell": cell_name, "seed": seed, "seconds": seconds, "trace": trace,
        "torch": torch.__version__, "card": _power_limit() if cuda else None,
        "setup_s": setup_s, "setup_phases": phases,
        "calls": w["attempted"], "window_s": w["window_s"],
        "designs": w["designs"],
        "call_ms": _quartiles(w["walls"]),
        "enqueue_ms": _quartiles(w["enqueue"]),
        "rows_compared": sum(len(r) for _, r, _ in w["records"]),
        "widest_gap_at": where, "reference_s": ref_s,
        "errors": w["errors"][:5]}
    if prof is not None:
        detail["profile"] = {k: v for k, v in prof.items()
                             if k not in ("by_kernel", "idle_gaps")}
    lines = [f"check {k} {readings[k]!r} limit {lim!r}"
             for k, lim in check.LIMITS.items()]
    return {"result": result, "detail": detail, "check_lines": lines}


def _quartiles(xs) -> dict | None:
    if len(xs) < 2:
        return None
    ms = [x * 1e3 for x in xs]
    q = statistics.quantiles(ms, n=4)
    return {"n": len(xs), "q1": q[0], "median": q[1], "q3": q[2],
            "p95": float(np.percentile(ms, 95)), "max": max(ms)}

