"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

The dry-run joins a fake world, which becomes its process's default
process group, so every run here is a subprocess of its own:

* ``--list`` prints the JAX package's cells and skips;
* ``make_production_mesh``'s shapes and axis names on fake worlds of 256
  and 512 ranks, ``cuda`` without a card and a torch without the ``fake``
  backend raising;
* ``whisper-base`` × ``train_4k`` × ``single`` on ``--device cpu``, the
  JAX package's own dry-run test (``tests/test_launchers.py``): an ``ok``
  record in the JAX layout with FLOPs and collective wire bytes;
* a second run reads the record back; a planted failing cell is recorded
  with ``ok: false`` and the sweep goes on to exit 1;
* the walk of a step on a fake 2 x 2 world with ``meta`` tensors equals
  rank 0's walk of the same step in a real 2 x 2 gloo world, key for key
  (reduced Llama and Mamba2, train and decode; ``torch_dryrun_check``);
* a train step's products on a fake 1 x 4 world count a quarter of
  their FLOPs on a fake 1 x 1 world, where the plan splits every product
  over tp (``torch_dryrun_check.SPLIT_ARCHS``): no rank multiplies a
  whole weight in the backward;
* ``flash_attention`` on ``meta`` tensors charges what the CPU route
  charges and returns an empty tensor of the output's shape.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dryrun_check as walks_check  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1"}
#: the JAX dry-run record's keys that the port keeps
JAX_KEYS = {"cell", "arch", "shape", "mesh", "mesh_shape", "kind", "plan",
            "ok", "memory", "collectives", "walk", "total_s"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "peak_memory_in_bytes"}


def _dryrun(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)


def _python(code: str, timeout=120):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_list_prints_the_jax_cells():
    from repro.configs import cells
    r = _dryrun("--list")
    assert r.returncode == 0, r.stderr[-2000:]
    want = [f"{a:24s} {s:12s} {'SKIP' if sk else ''}"
            for a, s, sk in cells(include_skipped=True)]
    assert r.stdout.splitlines() == want


def test_production_mesh_and_fake_world():
    """16 x 16 (data, model) and 2 x 16 x 16 (pod, data, model) on fake
    worlds of their sizes; ``cuda`` without a card raises; so does a torch
    without the ``fake`` backend, naming it."""
    r = _python(r"""
import json, sys
import torch, torch.distributed as dist
from repro_torch.launch import mesh as M
out = {}
for multi, world in ((False, 256), (True, 512)):
    M.join_fake_world(world)
    m = M.make_production_mesh(multi_pod=multi, device="cpu")
    out[str(world)] = [list(m.shape), list(m.mesh_dim_names),
                       m.device_type, dist.get_rank(), m.get_local_rank("model")]
    if not torch.cuda.is_available():
        try:
            M.make_production_mesh(multi_pod=multi)
        except RuntimeError as e:
            out["cuda"] = str(e)
    dist.destroy_process_group()
sys.modules["torch.testing._internal.distributed.fake_pg"] = None
try:
    M.join_fake_world(4)
except RuntimeError as e:
    out["no_fake"] = str(e)
print(json.dumps(out))
""")
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["256"] == [[16, 16], ["data", "model"], "cpu", 0, 0]
    assert got["512"] == [[2, 16, 16], ["pod", "data", "model"], "cpu", 0,
                          0]
    if not torch.cuda.is_available():
        assert "needs a visible CUDA card" in got["cuda"]
    assert "no fake process-group backend" in got["no_fake"]


@pytest.fixture(scope="module")
def whisper(tmp_path_factory):
    """The JAX package's dry-run test cell, walked once: (its process,
    its record, the output directory)."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    r = _dryrun("--arch", "whisper-base", "--shape", "train_4k", "--mesh",
                "single", "--device", "cpu", "--out", out)
    path = os.path.join(out, "whisper-base__train_4k__single.json")
    with open(path) as f:
        return r, json.load(f), out


def test_whisper_cell_is_ok_in_the_jax_layout(whisper):
    r, rec, _ = whisper
    assert r.returncode == 0, (r.stdout[-500:], r.stderr[-2000:])
    assert "[ok] whisper-base__train_4k__single" in r.stdout
    assert rec["ok"]
    assert rec["walk"]["flops"] > 0
    assert rec["collectives"]["total_wire"] > 0
    assert JAX_KEYS | {"walk_s"} <= set(rec)
    assert not {"cost", "hlo_bytes", "lower_s", "compile_s"} & set(rec)
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["kind"] == "train" and rec["plan"]["fsdp_axes"] == ["data"]
    assert MEMORY_KEYS <= set(rec["memory"])
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_memory_in_bytes"]
    assert rec["walk"]["collective_wire_bytes"]["all-gather"] > 0
    from repro_torch.roofline.analysis import analyze_cell, load_artifacts
    assert load_artifacts(whisper[2], "single") == [rec]
    assert analyze_cell(rec).n_dev == 256


def test_record_read_back_and_a_failing_cell(whisper):
    """Without ``--force`` the record is read back, not walked again; a
    cell whose step fails is recorded with ``ok: false``, its error and
    traceback, the next cell still runs, and the exit code is 1."""
    _, rec, out = whisper
    path = os.path.join(out, "whisper-base__train_4k__single.json")
    stamp = os.stat(path).st_mtime_ns
    r = _python(f"""
import repro_torch.launch.steps as S
from repro_torch.launch import dryrun
real = S.build_step
def build_step(cfg, shape, mesh, plan=None):
    if shape.name == "prefill_32k":
        raise RuntimeError("planted failure")
    return real(cfg, shape, mesh, plan)
S.build_step = build_step
raise SystemExit(dryrun.main(["--arch", "whisper-base", "--shape",
    "train_4k,prefill_32k,decode_32k", "--mesh", "single", "--device",
    "cpu", "--out", {out!r}]))
""", timeout=240)
    assert r.returncode == 1, r.stderr[-2000:]
    assert os.stat(path).st_mtime_ns == stamp
    with open(path) as f:
        assert json.load(f) == rec
    with open(os.path.join(out, "whisper-base__prefill_32k__single.json")) \
            as f:
        bad = json.load(f)
    assert not bad["ok"] and bad["error"] == "RuntimeError: planted failure"
    assert "planted failure" in bad["traceback"]
    with open(os.path.join(out, "whisper-base__decode_32k__single.json")) \
            as f:
        assert json.load(f)["ok"]
    lines = [l for l in r.stdout.splitlines() if l.startswith("[")]
    assert [l.split()[0] for l in lines] == ["[ok]", "[FAIL]", "[ok]"]


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    """The cases' walks: rank 0 of a real 2 x 2 gloo world, and rank 0 of
    a fake world on meta tensors."""
    d = tmp_path_factory.mktemp("walks")
    fake = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dryrun_check.py"),
         str(d / "fake.json")], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    walks_check.spawn_real(str(d / "real.json"))
    _, err = fake.communicate(timeout=240)
    assert fake.returncode == 0, err[-2000:]
    out = {}
    for name in ("real", "fake"):
        with open(d / f"{name}.json") as f:
            out[name] = json.load(f)
    return out


@pytest.mark.parametrize("case", [f"{a}/{k}"
                                  for a, k, _, _ in walks_check.CASES])
def test_fake_world_walk_equals_the_real_one(walks, case):
    """Every key of the walk (FLOPs, bytes, transcendentals, collectives
    by kind, FLOPs by dtype) and the hand kernels' charges equal."""
    real, fake = walks["real"][case], walks["fake"][case]
    assert real["flops"] > 0 and real["total_wire_bytes"] > 0
    assert sorted(real) == sorted(fake)
    for k in real:
        assert fake[k] == real[k], (k, fake[k], real[k])


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Each split arch's products' FLOPs on 1 x 1 and on 1 x SPLIT_TP."""
    out = tmp_path_factory.mktemp("split") / "split.json"
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "tests", "torch_dryrun_check.py"), "--split", str(out)],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", walks_check.SPLIT_ARCHS)
def test_products_split_over_tp(split, arch):
    """Rank 0's products on 1 x N are 1/N of the whole step's, within 1 %
    (before the residual's gradient was made whole over tp, DTensor
    all-gathered the output projections' weights in the backward: a
    sixteenth of Llama-3.2-1B's step counted 2.3x its share)."""
    whole, part = split[arch]
    assert whole > 0
    assert part * walks_check.SPLIT_TP == pytest.approx(whole, rel=0.01)


@pytest.mark.parametrize("causal,window,Sq,Sk", [(True, None, 40, 40),
                                                  (False, None, 8, 24),
                                                  (True, 16, 40, 40)])
def test_flash_attention_on_meta_charges_as_on_the_cpu(causal, window, Sq,
                                                       Sk):
    from repro_torch.gpu.op_walk import OpWalk
    from repro_torch.kernels.flash_attn import flash_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, Sq, 4, 16, generator=g)
    k = torch.randn(2, Sk, 2, 16, generator=g)
    v = torch.randn(2, Sk, 2, 16, generator=g)
    costs = {}
    for dev in ("cpu", "meta"):
        qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
        with OpWalk() as w:
            out = flash_attention(qd, kd, vd, causal=causal, window=window)
        costs[dev] = w.costs()
        assert out.shape == q.shape and out.dtype == q.dtype
        assert out.device.type == dev and out.is_contiguous()
    cpu, meta = costs["cpu"], costs["meta"]
    assert meta.charges == cpu.charges == {"flash_fwd": 1}
    for k in ("flops", "bytes_accessed", "transcendentals"):
        assert getattr(meta, k) == getattr(cpu, k) > 0
    assert meta.census == cpu.census == {}
