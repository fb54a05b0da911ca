"""Whole runs on the CPU, past the harness's look for a card: a sound run
is correct, and a run with the timed path broken underneath is not."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

from mccm_bench import bench, cells

CELLS = [c["name"] for c in cells.load_spec()["workloads"]]
SMALL = {"designs_per_call": 512, "pool_batches": 2, "warmup_calls": 1,
         "trace_calls": 2}


def _run(cell, trace=False, seed=2**31 + 3):
    return bench.run(cell, seed, 0.5, trace, device="cpu",
                     mix_override=SMALL)["result"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"designs_per_s", "call_p95_ms", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_rel_gap"]["value"] == 0.0


def test_traced_run_reads_what_the_cpu_has():
    """On the CPU the trace holds no device events: the readers of device
    numbers return nothing and the host's reader its number."""
    r = _run(CELLS[0], trace=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"enqueue_ms"}


def _stale(monkeypatch):
    """Each call hands back the previous call's metrics."""
    from repro_torch.core import session
    real, last = session.Session.evaluate, {}

    def evaluate(self, designs, net, *a, **k):
        out = real(self, designs, net, *a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    monkeypatch.setattr(session.Session, "evaluate", evaluate)


def _half(monkeypatch):
    """Half of each batch is left out; its rows get the mean of the
    rest."""
    from repro_torch.core import session
    real = session.evaluate_batch

    def evaluate_batch(design, *a, **k):
        half = design.batch // 2
        out = real(design.take(slice(0, half)), *a, **k)
        res = {}
        for m, v in out.items():
            fill = v.to(torch.float64).mean().to(v.dtype)
            res[m] = torch.cat([v, fill.expand(design.batch - half)])
        return res
    monkeypatch.setattr(session, "evaluate_batch", evaluate_batch)


def _altered(monkeypatch):
    """The search's answer is altered where it is produced: each CE's pw
    one candidate lower."""
    from repro_torch.core import batch_eval
    real = batch_eval.parallelism_search

    def search(*args):
        pf, ph, pw, cost = real(*args)
        return pf, ph, torch.clamp_min(pw / 2, 1.0), cost
    monkeypatch.setattr(batch_eval, "parallelism_search", search)


def _nudged(monkeypatch):
    """One metric altered by a part in a thousand where it is produced."""
    from repro_torch.core import batch_eval
    real = batch_eval.compose_metrics

    def compose(*args):
        out = real(*args)
        out["latency_s"] = out["latency_s"] * 1.001
        return out
    monkeypatch.setattr(batch_eval, "compose_metrics", compose)


def _raises(monkeypatch):
    """The search fails at launch once set-up is over."""
    from repro_torch.core import batch_eval
    real, calls = batch_eval.parallelism_search, []

    def search(*args):
        calls.append(1)
        if len(calls) > SMALL["warmup_calls"] * 4:
            raise RuntimeError("planted launch failure")
        return real(*args)
    monkeypatch.setattr(batch_eval, "parallelism_search", search)


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _nudged,
                                   _raises])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run(CELLS[0])
    assert r["correct"] is False, r["checks"]


BENCH_DIR = cells.BENCH_DIR
#: modules of the benchmark that read nothing of the program
YARDSTICK = ("reference.py", "traffic.py", "check.py", "yardstick.py",
             "profile.py", "cells.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        found = set(_imports(p)) & bench.FORBIDDEN_MODULES
        assert not found, (p, found)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in set(_imports(BENCH_DIR / name))


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process leaves JAX and the JAX package
    out of ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from mccm_bench import bench\n"
        "r = bench.run({cell!r}, 5, 0.3, False, device='cpu', "
        "mix_override={small!r})\n"
        "assert r['result']['correct']\n"
        "print(bench.forbidden_modules())\n").format(
            root=str(cells.ROOT), src=str(cells.ROOT / "src"),
            cell=CELLS[0], small=SMALL)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Where no card is visible the command exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell):
    """A short run of each cell on the card is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a visible CUDA card")
    r = bench.run(cell, 2**31 + 101, 2.0, False, device="cuda")["result"]
    assert r["correct"] and r["device"]["platform"] == "gpu"
