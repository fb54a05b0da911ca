"""The port's runnable examples (``examples/torch/``) against the JAX
package's (``examples/``) on the CPU.

``quickstart``, ``dse_explore`` and ``multinet_deploy`` run as
subprocesses beside their JAX originals, with the same small arguments
(the twin with ``--device cpu``), and must print the same report: each
line's text equal once its numbers are taken out, the numbers within
rtol 1e-5 (a printed number may also differ by one unit of its last digit,
where the two values straddle a rounding boundary), integers exactly, the
lines of the scalar Builder (plain Python in both packages) character for
character, the timing fields (seconds, µs a design or deployment) masked,
by ``chip_smoke.report_diff`` (the comparison phase 22 makes on the
card).  The DSE's printed fronts are compared as sets: a near-tie may
swap two rows.  ``serve_lm``'s generation function, handed the JAX package's
weights through ``from_jax`` in f32, gives the JAX ``ServeEngine``'s
greedy tokens exactly; ``train_lm`` commits a checkpoint and a second run
resumes from it; ``autoplan_gpu``'s ranking on a ``ChipSpec`` with the
v5e's figures is the JAX ``rank``'s, plan for plan.  Every twin's
subprocess ends with neither ``jax`` nor any ``repro.*`` module loaded.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import runpy
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.models.runtime import Runtime as JaxRuntime
from repro.serve.engine import ServeEngine as JaxEngine
from repro.tpu.autoplan import rank as jax_rank
from repro.tpu.chip import V5E
from repro_torch import configs as port_configs
from repro_torch.configs import get_config
from repro_torch.gpu.chip import H100, ChipSpec
from repro_torch.models.convert import from_jax
from torch_lm_cases import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TWINS = os.path.join(EXAMPLES, "torch")
TWIN_NAMES = ("quickstart", "dse_explore", "multinet_deploy", "serve_lm",
              "train_lm", "autoplan_gpu")
TIMEOUT_S = 300
#: chip_smoke.py, whose phase 22 compares two reports as the tests do
CS = chip_smoke()
#: the port's chip spec with the JAX package's v5e figures, as
#: ``tests/test_torch_cost_model.py`` builds it
V5E_SPEC = ChipSpec(name=V5E.name, peak_flops_bf16=V5E.peak_flops_bf16,
                    hbm_bytes_per_s=V5E.hbm_bytes_per_s,
                    hbm_capacity=V5E.hbm_capacity,
                    link_bytes_per_s=V5E.ici_link_bytes_per_s,
                    links=V5E.ici_links, mma_tile=V5E.mxu_tile)

#: runs a script as ``__main__`` with the given argv, then reports on
#: stderr the modules of jax and of the JAX package it left loaded
RUNNER = (
    "import json, runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    if e.code not in (None, 0):\n"
    "        raise\n"
    "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
    "             or m.startswith(('jax.', 'repro.')))\n"
    "print('LOADED ' + json.dumps(bad), file=sys.stderr)\n")

def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)


def _start(path: str, args, cwd: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", RUNNER, path, *args],
                            env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, what: str) -> tuple[str, list]:
    """(stdout, the jax/repro modules left loaded) of a finished run."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"{what}: exit {proc.returncode}\n{err}"
    loaded = [ln for ln in err.splitlines() if ln.startswith("LOADED ")]
    assert loaded, f"{what}: no module report\n{err}"
    return out, json.loads(loaded[-1][len("LOADED "):])


def run_twin(name: str, args, cwd: str) -> str:
    """The twin's stdout, run with ``--device cpu``; it must leave jax and
    the JAX package unloaded."""
    out, loaded = _finish(
        _start(os.path.join(TWINS, f"{name}.py"), [*args, "--device", "cpu"],
               cwd), name)
    assert loaded == [], f"{name} loaded {loaded}"
    return out


def run_pair(name: str, args, cwd: str) -> tuple[str, str]:
    """(the JAX example's stdout, the twin's), run side by side."""
    jax_run = _start(os.path.join(EXAMPLES, f"{name}.py"), args, cwd)
    try:
        twin = run_twin(name, args, cwd)
    finally:
        want, _ = _finish(jax_run, f"examples/{name}.py")
    return want, twin


#: the arguments of each example compared with its JAX original
REPORT_ARGS = {"quickstart": (), "dse_explore": ("--n", "999"),
               "multinet_deploy": ("--n", "256")}


@pytest.mark.parametrize("name", list(REPORT_ARGS))
def test_twin_prints_the_jax_report(name, tmp_path):
    """The comparison is ``chip_smoke.report_diff``, which phase 22 makes
    between the card's report and the CPU's, with its lines held exactly
    (``EXAMPLE_EXACT``) and as sets (``EXAMPLE_SETS``)."""
    want, got = run_pair(name, REPORT_ARGS[name], str(tmp_path))
    assert want.strip()
    assert CS.report_diff(got, want, CS.EXAMPLE_EXACT[name],
                          CS.EXAMPLE_SETS.get(name, ())) == []


def test_report_diff_masks_timings_and_holds_the_rest():
    want = ("template best: segmented tp 12.3/s, buffers 4.56 MiB\n"
            "random: 999 designs in 1.7s (1743 µs/design)\n"
            "  tp   20.1/s  buf   1.00 MiB  {L1-L10:CE1}\n"
            "  tp   19.5/s  buf   0.90 MiB  {L1-Last:CE1-CE2}\n"
            "  latencies: 12.3ms 45.6ms")
    exact, sets = ("template best",), ("  tp ",)

    def diff(got):
        return CS.report_diff(got, want, exact, sets)
    assert diff(want) == []
    lines = want.splitlines()
    # timings differ, fronts swap rows, a batch number crosses a rounding
    # boundary: the same report
    ok = [lines[0], "random: 999 designs in 0.2s (25 µs/design)", lines[3],
          lines[2], "  latencies: 12.4ms 45.6ms"]
    assert diff("\n".join(ok)) == []
    bad = {0: "template best: segmented tp 12.4/s, buffers 4.56 MiB",
           1: "random: 998 designs in 1.7s (1743 µs/design)",
           2: "  tp   20.1/s  buf   1.00 MiB  {L1-L11:CE1}",
           4: "  latencies: 12.5ms 45.6ms"}
    for i, line in bad.items():
        got = list(lines)
        got[i] = line
        assert diff("\n".join(got)), line
    assert diff("\n".join(lines[:-1]))


def _twin_module(name: str) -> dict:
    return runpy.run_path(os.path.join(TWINS, f"{name}.py"))


def test_serve_lm_on_jax_weights_gives_jax_greedy_tokens():
    """The twin's generation function on the JAX package's weights, in f32
    on the CPU: the greedy tokens of the JAX ``ServeEngine`` with the JAX
    example's settings, token for token."""
    twin = _twin_module("serve_lm")
    jcfg = jax_config("llama3.2-1b").reduced().replace(dtype="float32")
    cfg = get_config("llama3.2-1b").reduced().replace(dtype="float32")
    engine = JaxEngine(jcfg, rt=JaxRuntime(), temperature=0.0)
    params = engine.api.init(jax.random.key(0))
    prompts = twin["prompts_of"](cfg)
    assert [len(p) for p in prompts] == [12, 24, 7, 18]
    want = engine.generate(params, prompts, max_new_tokens=24)
    model = from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res, res_t = twin["serve"](cfg, model, "cpu")
    assert res.tokens == want.tokens
    assert (res.n_prefill, res.n_steps) == (want.n_prefill, want.n_steps)
    for i, toks in enumerate(want.tokens):
        assert f"request {i}: " in out.getvalue()
        assert str(toks[:10]) in out.getvalue()
    assert len(res_t.tokens) == 2 and len(res_t.tokens[0]) == 12
    assert all(0 <= t < cfg.vocab_size for t in res_t.tokens[0])


def test_serve_lm_twin_runs_on_the_cpu(tmp_path):
    out = run_twin("serve_lm", (), str(tmp_path))
    assert len(re.findall(r"^request \d: ", out, re.M)) == 4
    assert "prefill: 24 positions" in out and "decode : 24 steps" in out
    assert "sampled (T=0.8): [" in out


TRAIN_ARGS = ("--steps", "3", "--ckpt-every", "2")


@pytest.fixture(scope="module", autouse=True)
def train_first_run(tmp_path_factory):
    """train_lm's first run, started with the module's first test so that
    it runs beside the others (one torch thread); its checkpoints are
    removed at the module's end."""
    d = tmp_path_factory.mktemp("train_lm")
    ck = str(d / "ck")
    proc = _start(os.path.join(TWINS, "train_lm.py"),
                  [*TRAIN_ARGS, "--ckpt-dir", ck, "--device", "cpu"], str(d))
    try:
        yield proc, ck
    finally:
        proc.kill()
        proc.wait()
        shutil.rmtree(ck, ignore_errors=True)


def test_train_lm_commits_and_resumes(train_first_run, tmp_path):
    """Three steps commit step 2; a second run resumes there and its step
    2 repeats the first run's loss."""
    proc, ck = train_first_run
    first, loaded = _finish(proc, "train_lm")
    assert loaded == []
    assert "model: lm-100m, 66.3M params" in first
    assert f"[ckpt] committed step 2 -> {ck}" in first
    assert "done: 3 steps" in first
    second = run_twin("train_lm", (*TRAIN_ARGS, "--ckpt-dir", ck),
                      str(tmp_path))
    assert "[restore] resumed from committed step 2 (device cpu)" in second
    assert "done: 1 steps" in second

    def step2(out):
        return re.search(r"^step +2  loss (\S+)", out, re.M).group(1)
    assert step2(second) == step2(first)


@pytest.mark.parametrize("arch,shape", [("qwen2.5-32b", "train_4k"),
                                        ("granite-moe-1b-a400m", "train_4k"),
                                        ("llama3.2-1b", "decode_32k")])
def test_autoplan_ranks_as_jax_on_v5e_figures(arch, shape):
    twin = _twin_module("autoplan_gpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = twin["table"](arch, shape, V5E_SPEC)
    want = jax_rank(jax_config(arch), JAX_SHAPES[shape],
                    twin["MeshView"]({"data": 16, "model": 16}))

    def rows(ranked):
        return [(r.plan.name, r.plan.remat, r.plan.remat_group, r.step_s,
                 r.est.fits) for r in ranked]
    assert rows(got) == rows(want)
    assert f"ranked {len(want)} plans" in out.getvalue()


def test_autoplan_on_h100_puts_feasible_plans_first(tmp_path):
    table = _twin_module("autoplan_gpu")["table"]
    for arch in ("qwen2.5-32b", "llama3.2-1b"):
        with contextlib.redirect_stdout(io.StringIO()):
            ranked = table(arch, "train_4k", H100)
        fits = [r.est.fits for r in ranked]
        assert fits == sorted(fits, reverse=True) and fits[0]
        for a, b in zip(ranked, ranked[1:]):
            if a.est.fits == b.est.fits:
                assert a.step_s <= b.step_s
    out = run_twin("autoplan_gpu", (), str(tmp_path))
    assert out.startswith("qwen2.5-32b × train_4k on 16×16 h100-sxm")
    assert "faster than the worst candidate" in out


@pytest.mark.parametrize("name", TWIN_NAMES)
def test_twin_needs_a_card_by_default(name, monkeypatch, tmp_path):
    """Without ``--device cpu`` a twin asks for the card and raises where
    none is visible; nothing runs it on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # train_lm registers its config: keep that out of the other tests
    monkeypatch.setattr(port_configs, "ARCHS", dict(port_configs.ARCHS))
    main = _twin_module(name)["main"]
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match="(?i)cuda"):
        main(argv)
