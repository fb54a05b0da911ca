"""The LM mesh on a 4-rank gloo world on the CPU, against the JAX package.

``torch_mesh_check`` (beside this file) runs the port's mesh routes in spawned
ranks (a ``file://`` rendezvous under ``tmp_path``, so pytest's
parallel workers never share a port): once on a 2 x 2 (data, model) mesh
and once on a 1 x 1 mesh in a world of one.  Rank 0 hands back arrays;
the cases here hold them against ``golden_mesh.npz`` (the JAX package on a
2 x 2 host mesh, ``tests/torch_golden.py::compute_golden_mesh``):

* the reduced f32 Llama's loss and gradients under data and tensor
  parallelism (``tp_dp``), ZeRO-3 (``fsdp``) and ``act_shard="seq"``,
  Granite's under the first two, a ``build_train`` step, prefill's logits and the greedy decode's tokens
  on ``cache_pspecs``' placements: loss within 1e-5, gradients, params
  and logits within 5e-5 of each leaf's own scale, tokens exact;
* heads that do not divide tp on a 1 x 4 mesh (kv heads repeated, a
  sequence-sharded decode cache; heads padded) against the JAX package
  on its 1 x 4 host mesh, with the same tolerances;
* ``moe_ep`` and ``moe_ep_a2a`` on an input whose shards drop
  assignments (some are dropped), and the collectives each runs;
* the int8 compressed step: its averaged gradients and residuals at most
  one quantum (the shared scale) from JAX's, where the two round an
  element on opposite sides of .5 (the count of such elements is held
  too), and its 12 losses within 1e-5;
* a 1 x 1 mesh bit-equal to the unsharded route; the elastic reshard (a
  checkpoint saved on 2 x 2, restored onto 4 x 1 and 1 x 1) bit-equal;
* the train launcher's ``--dp 2 --tp 2`` (and ``--compress``) crash at
  step 3 and resume from step 2, as ``tests/test_launchers.py`` does at
  15 and 10;
* no rank imports ``jax`` or the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_check as mesh_check  # noqa: E402
from torch_golden import (GOLDEN_MESH, MESH_ARCHS,  # noqa: E402
                          GoldenMeshRun)
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA, GRANITE = MESH_ARCHS
#: each train plan of the golden file, per arch
TRAIN_CASES = [(LLAMA, "tp_dp"), (LLAMA, "fsdp"), (LLAMA, "seq"),
               (GRANITE, "tp_dp"), (GRANITE, "fsdp")]
#: the most elements of a compressed step's averaged gradients and of its
#: residuals that may round to the other side of .5 than JAX's (the CPU
#: run here: 0 and 1 of 8,770 and 12,194 elements, Llama and Granite)
MAX_FLIPS = 8


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_MESH) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_golden():
    """The JAX package's golden mesh run, started with the module's first
    test so that it runs beside the port's ranks and the launcher;
    ``test_golden_mesh_is_current`` reads it."""
    run = GoldenMeshRun()
    yield run
    run.stop()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_golden):
    """The 2 x 2 world's arrays, the 1 x 1 world's, and the checkpoint
    directory the first saved (one spawn each)."""
    d = tmp_path_factory.mktemp("mesh")
    ck = str(d / "ckpt")
    out = {}
    for world in (4, 1):
        path = str(d / f"world{world}.npz")
        mesh_check.spawn(world, path, ck)
        with np.load(path) as z:
            out[world] = {k: z[k] for k in z.files}
    out["ckpt"] = ck
    return out


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _tree(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("arch,plan", TRAIN_CASES)
def test_mesh_loss_and_grads_match_jax(runs, golden, arch, plan):
    got, pre = runs[4], f"{arch}/train/{plan}/"
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(got[pre + k], golden[pre + k], rtol=0,
                                   atol=1e-5, err_msg=pre + k)
    want = _tree(golden, pre + "grads/")
    grads = _tree(got, pre + "grads/")
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        _close(grads[k], w, 5e-5, pre + k)


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_train_step_matches_jax(runs, golden, arch):
    """One ``build_train`` step (data and tensor parallelism): the loss,
    the gradient norm over shards, and every updated parameter."""
    got, pre = runs[4], f"{arch}/step/"
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[pre + k], golden[pre + k], rtol=0,
                                   atol=1e-5, err_msg=pre + k)
    want = _tree(golden, pre + "params/")
    assert sorted(_tree(got, pre + "params/")) == sorted(want)
    for k, w in want.items():
        _close(got[pre + "params/" + k], w, 5e-5, pre + k)


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_prefill_and_decode_match_jax(runs, golden, arch):
    """Prefill's last logits, the first decode step's and the greedy
    tokens on a cache whose kv heads are sharded over tp."""
    got, pre = runs[4], f"{arch}/"
    assert "Shard(dim=3)" in str(got[pre + "cache_placements"])
    for k in ("prefill/logits", "decode/logits0"):
        _close(got[pre + k], golden[pre + k], 5e-5, pre + k)
    np.testing.assert_array_equal(got[pre + "decode/tokens"],
                                  golden[pre + "decode/tokens"])


@pytest.mark.parametrize("case", ["kv", "pad"])
def test_heads_that_do_not_divide_tp(runs, golden, case):
    """On a 1 x 4 mesh: ``kv`` (2 kv heads repeated to the 4 heads in
    prefill; the decode cache sharded on its sequence, the softmax
    reduced across it) and ``pad`` (6 heads padded to 8, 2 a rank):
    prefill's and the first decode step's logits and the gradients within
    5e-5 of each leaf's scale of JAX's on its 1 x 4 mesh, the loss within
    1e-5, the greedy tokens equal."""
    pre = f"odd/{case}/mesh/"
    got, want = _tree(runs[4], pre), _tree(golden, pre)
    assert "Shard(dim=2)" in str(got.pop("cache_placements"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], w, err_msg=pre + k)
        elif k in ("loss", "nll", "aux"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5,
                                       err_msg=pre + k)
        else:
            _close(got[k], w, 5e-5, pre + k)


@pytest.mark.parametrize("impl", ["ep", "ep_a2a"])
def test_expert_parallel_moe_matches_jax(runs, golden, impl):
    """Shard-local routing, capacity and aux: the output within 5e-5 of
    its scale and the aux within 1e-5 of JAX's, with assignments dropped
    past each shard's capacity; ``ep`` sums its experts' parts
    (all_reduce), ``ep_a2a`` exchanges them (two all_to_all)."""
    got, pre = runs[4], f"{GRANITE}/moe/{impl}/"
    _close(got[pre + "y"], golden[pre + "y"], 5e-5, pre + "y")
    np.testing.assert_allclose(got[pre + "aux"], golden[pre + "aux"],
                               rtol=0, atol=1e-5)
    assert int(got[pre + "dropped"]) > 0
    coll = json.loads(str(got[pre + "collectives"]))
    if impl == "ep_a2a":
        assert coll["all_to_all"]["count"] >= 2, coll
    else:
        assert coll["all_reduce"]["count"] >= 1, coll


def test_local_moe_on_a_mesh_is_the_global_route(runs):
    """``moe_impl="local"`` on a mesh routes all the tokens together (the
    JAX package's ``local`` under GSPMD): ``moe_local`` on one device,
    within 5e-5 of its scale."""
    got, pre = runs[4], f"{GRANITE}/moe/"
    for k in ("y", "aux"):
        _close(got[pre + "local/" + k], got[pre + "local_plain/" + k], 5e-5,
               k)


def _quanta(got, golden, arch, part: str) -> tuple[float, int]:
    """The largest distance, in quanta of each leaf's shared scale, of a
    compressed step's ``part`` from JAX's, and how many elements differ."""
    pre = f"{arch}/compress/"
    worst, flips = 0.0, 0
    for k, w in _tree(golden, pre + part + "/").items():
        path = k.split("/", 1)[1] if part.startswith("residuals") else k
        q = np.abs(got[pre + part + "/" + k] - w) / golden[
            pre + "scales/" + path]
        worst = max(worst, float(q.max(initial=0.0)))
        flips += int((q > 1e-3).sum())
    return worst, flips


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_compressed_step_matches_jax(runs, golden, arch):
    """The int8 wire protocol: the scales within 1e-5 (they are the
    gradients' absmax), the averaged gradients
    and both data shards' residuals within one quantum, at most
    ``MAX_FLIPS`` elements off by it, and 12 steps' losses within 1e-5."""
    got, pre = runs[4], f"{arch}/compress/"
    for k, w in _tree(golden, pre + "scales/").items():
        np.testing.assert_allclose(got[pre + "scales/" + k], w, rtol=1e-5)
    for part in ("grads", "residuals"):
        assert len(_tree(got, pre + part + "/")) == len(
            _tree(golden, pre + part + "/"))
        worst, flips = _quanta(got, golden, arch, part)
        assert worst <= 1.0 + 1e-3 and flips <= MAX_FLIPS, (part, worst,
                                                            flips)
    np.testing.assert_allclose(got[pre + "losses"], golden[pre + "losses"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ["train", "serve"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_one_by_one_mesh_is_bit_equal(runs, arch, route):
    """A 1 x 1 mesh through ``build_step`` equals the unsharded route bit
    for bit: a train step's loss, gradient norm and parameters; prefill's
    logits, the first decode step's and the greedy tokens."""
    got = runs[1]
    mesh = _tree(got, f"one/{arch}/{route}/mesh/")
    plain = _tree(got, f"one/{arch}/{route}/plain/")
    mesh.pop("cache_placements", None)
    assert mesh and sorted(mesh) == sorted(plain)
    for k in mesh:
        np.testing.assert_array_equal(mesh[k], plain[k], err_msg=k)


@pytest.mark.parametrize("target", ["4x1", "1x1"])
def test_elastic_reshard_is_bit_equal(runs, target):
    """A 2 x 2 train state's checkpoint restored onto another mesh holds
    the saved arrays bit for bit (parameters, moments, count, step): onto
    4 x 1 through ``restore(..., shardings=)`` from a one-device state,
    onto 1 x 1 into a state already placed there."""
    got = runs[4] if target == "4x1" else runs[1]
    with np.load(os.path.join(runs["ckpt"], "2x2", "step_00000001",
                              "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    restored = _tree(got, f"reshard/{target}/")
    assert sorted(restored) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k].astype(v.dtype), v,
                                      err_msg=k)


def test_ranks_import_neither_jax_nor_repro(runs):
    for world in (4, 1):
        assert json.loads(str(runs[world]["modules/bad"])) == []


def _launch(args, ck):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--dp", "2", "--tp", "2", "--steps", "4",
         "--ckpt-dir", ck, "--ckpt-every", "2", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("mode", ["fsdp_tp", "compress"])
def test_train_launcher_mesh_crash_restart(tmp_path, mode):
    """``--dp 2 --tp 2`` spawns four ranks, crashes after step 3 (exit 42)
    with step 2 committed, and resumes from step 2 on the same mesh to
    step 4; the manifest records the mesh.  ``tests/test_launchers.py``'s
    crash at 15 of 20 on one device, cut to the fewest steps that still
    crash between two checkpoints (each step of four ranks on the CPU
    costs about a second)."""
    ck = str(tmp_path / "ck")
    extra = ["--compress"] if mode == "compress" else []
    r1 = _launch(["--crash-at", "3", *extra], ck)
    assert r1.returncode == 42, r1.stderr[-2000:]
    assert "committed step 2" in r1.stdout
    r2 = _launch(extra, ck)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from committed step 2" in r2.stdout
    assert "done: 2 steps" in r2.stdout
    with open(os.path.join(ck, "step_00000004", "manifest.json")) as f:
        assert json.load(f)["extra"]["mesh"] == {"data": 2, "model": 2}


def test_golden_mesh_is_current(golden, jax_golden):
    """The committed file equals what the JAX package computes on its
    2 x 2 and 1 x 4 host meshes: strings, batches, tokens and inputs
    exactly, the rest within 1e-6 of its scale (a different CPU's vector
    unit)."""
    want = jax_golden.result()
    assert sorted(golden) == sorted(want)
    for k, w in want.items():
        g = golden[k]
        if w.dtype.kind in "USOiu" or k.endswith("/moe/x"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)
