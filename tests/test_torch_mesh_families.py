"""The SSM, hybrid, enc-dec and VLM families on the LM mesh, on a 4-rank
gloo world on the CPU, against the JAX package.

``torch_mesh_families_check`` (beside this file) runs the reduced f32
Mamba2, Zamba2, Whisper and InternVL2 in four spawned ranks (a
``file://`` rendezvous under ``tmp_path``) on a 2 x 2 and a 1 x 4 (data,
model) mesh; rank 0 hands back arrays, which the cases here hold against
``golden_mesh_families.npz`` (the JAX package on its 2 x 2 and 1 x 4 host
meshes, ``tests/torch_golden.py::compute_golden_mesh_families``) with the
tolerances ``tests/test_torch_mesh.py`` holds the dense and MoE families
to: the loss within 1e-5, gradients and logits within 5e-5 of each
leaf's own scale, greedy tokens exact.  On 1 x 4 the 4-wide model axis
does not divide the reduced Zamba2's, Whisper's and InternVL2's 2 kv
heads (repeated in prefill; the decode cache sharded on its sequence),
and Mamba2's in-projection stays whole over it; the ``long`` serving
plan shards the 1 x 4 Zamba2 cache's sequence and its shared block's head
dim.  Its own file, so that ``--dist loadfile`` does not put it behind
``test_torch_mesh.py``'s JAX subprocesses.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_families_check as fam_check  # noqa: E402
from torch_golden import (MESH_FAMILY_ARCHS,  # noqa: E402
                          MESH_FAMILY_MESHES, GoldenMeshRun)
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

CASES = [(m, a) for m in MESH_FAMILY_MESHES for a in MESH_FAMILY_ARCHS]


@pytest.fixture(scope="module")
def golden():
    return fam_check.golden()


@pytest.fixture(scope="module")
def jax_golden():
    """The JAX package's golden run, started with the module's first test
    so that it runs beside the port's ranks."""
    run = GoldenMeshRun(("families",))
    yield run
    run.stop()


@pytest.fixture(scope="module")
def got(tmp_path_factory, jax_golden):
    path = str(tmp_path_factory.mktemp("families") / "out.npz")
    fam_check.spawn(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _tree(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("mesh,arch", CASES)
def test_loss_and_grads_match_jax(got, golden, mesh, arch):
    """``default_plan``'s loss (ZeRO-3 over data, tp over model) and every
    gradient leaf, the mixer's FSDP-sharded ones among them."""
    pre = f"{mesh}/{arch}/train/"
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(got[pre + k], golden[pre + k], rtol=0,
                                   atol=1e-5, err_msg=pre + k)
    want = _tree(golden, pre + "grads/")
    grads = _tree(got, pre + "grads/")
    assert want and sorted(grads) == sorted(want)
    for k, w in want.items():
        _close(grads[k], w, 5e-5, pre + k)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_prefill_and_decode_match_jax(got, golden, mesh, arch):
    """Prefill's last logits, the first decode step's and the greedy
    tokens, on each serving plan the golden file holds for the case."""
    pre = f"{mesh}/{arch}/"
    keys = [k for k in golden if k.startswith(pre) and "/train/" not in k]
    assert keys
    for k in keys:
        if k.endswith("/decode/tokens"):
            np.testing.assert_array_equal(got[k], golden[k], err_msg=k)
        else:
            _close(got[k], golden[k], 5e-5, k)


def test_every_cache_leaf_is_placed(got):
    """The caches leave prefill on ``cache_pspecs``' placements: the
    Mamba2 conv window's channels and state's heads over model, Whisper's
    encoder states over data, the long Zamba2 cache's shared keys on its
    sequence and head dim."""
    def pl(key):
        return json.loads(str(got[key]))
    mamba = pl("2x2/mamba2-370m/cache_placements")["tail"]
    assert mamba == {"conv": "(Shard(dim=1), Shard(dim=3))",
                     "ssm": "(Shard(dim=1), Shard(dim=2))"}
    zamba = pl("2x2/zamba2-1.2b/cache_placements")
    assert zamba["shared_k"] == "(Shard(dim=1), Shard(dim=3))"
    assert zamba["groups"]["ssm"] == "(Shard(dim=2), Shard(dim=3))"
    assert pl("2x2/whisper-base/cache_placements")["enc_out"] == \
        "(Shard(dim=0), Replicate())"
    assert pl("1x4/zamba2-1.2b/long/cache_placements")["shared_k"] == \
        "(Shard(dim=2), Shard(dim=4))"
    assert pl("1x4/internvl2-2b/cache_placements")["k"] == \
        "(Shard(dim=1), Shard(dim=2))"


def test_ranks_import_neither_jax_nor_repro(got):
    assert json.loads(str(got["modules/bad"])) == []


def test_golden_mesh_families_is_current(golden, jax_golden):
    """The committed file equals what the JAX package computes on its
    meshes: strings, batches and tokens exactly, the rest within 1e-6 of
    its scale (a different CPU's vector unit)."""
    want = jax_golden.result()
    assert sorted(golden) == sorted(want)
    for k, w in want.items():
        g = golden[k]
        if w.dtype.kind in "USOiu" or "/batch/" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=k)
