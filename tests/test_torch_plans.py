"""The LM mesh's plans and specs against the JAX package's, without ranks.

``launch/plans.py``'s ``default_plan``, ``param_pspecs``, ``opt_pspecs``,
``batch_pspecs``, ``cache_pspecs`` and ``sanitize_pspecs`` equal the JAX
package's on every arch of the ten configs, every shape of ``SHAPES`` and
the meshes 1 x 1, 2 x 2, 16 x 16 and 2 x 16 x 16.  The meshes are
stand-ins whose ``.shape`` maps axis to width, which both packages' spec
functions take; the JAX parameter, optimizer and cache trees are
``jax.eval_shape``'s, the port's ``models/registry.py``'s meta tensors.
JAX's per-layer leaves are stacked on leading axes, so a port parameter's
spec must equal its JAX leaf's with those axes dropped.  Also
``registry.*_specs``' shapes and dtypes, ``gpu.cost_model.PlanView.of``,
``gpu.autoplan.candidate_plans`` and ``estimate`` on every candidate
(float for float, on the JAX package's chip figures).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.launch import plans as JPL
from repro.models import registry as JR
from repro.models.runtime import Runtime as JaxRuntime
from repro.tpu import autoplan as JAP
from repro.tpu import cost_model as JCM
from repro.tpu.chip import V5E
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.gpu import autoplan as AP
from repro_torch.gpu import cost_model as CM
from repro_torch.gpu.chip import ChipSpec
from repro_torch.launch import plans as PL
from repro_torch.models import registry as R
from repro_torch.models.convert import jax_path
from repro_torch.train.optimizer import make_optimizer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)


class Mesh:
    """A mesh stand-in: axis -> width."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"1x1": Mesh(data=1, model=1), "2x2": Mesh(data=2, model=2),
          "16x16": Mesh(data=16, model=16),
          "2x16x16": Mesh(pod=2, data=16, model=16)}
#: the JAX package's v5e figures as a port ChipSpec, so estimates match
V5E_SPEC = ChipSpec(name=V5E.name, peak_flops_bf16=V5E.peak_flops_bf16,
                    hbm_bytes_per_s=V5E.hbm_bytes_per_s,
                    hbm_capacity=V5E.hbm_capacity,
                    link_bytes_per_s=V5E.ici_link_bytes_per_s,
                    links=V5E.ici_links, mma_tile=V5E.mxu_tile)


def _spec(p) -> tuple:
    """A spec (a JAX PartitionSpec or the port's tuple) with each
    one-name tuple entry as that name: this JAX's PartitionSpec keeps
    ``("data",)`` as ``"data"``, the same axes."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: JR.get_model(cfg).init(jax.random.key(0)))


def jax_flat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[JPL._path_key(path)] = leaf
    return out


def jax_flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {JPL._path_key(p): _spec(s) for p, s in leaves}


def _fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plans_and_param_specs_equal_jax(arch, mesh):
    """default_plan field for field, and every parameter's (sanitized)
    spec and its optimizer moments', on every shape."""
    m = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_config(arch)
    jparams = jax_params(arch)
    jflat = jax_flat(jparams)
    sds = R.param_specs(cfg)
    for name, shape in SHAPES.items():
        plan = PL.default_plan(cfg, shape, m)
        jplan = JPL.default_plan(jcfg, JAX_SHAPES[name], m)
        assert _fields(plan) == _fields(jplan), (arch, name, mesh)
        jspecs = JPL.param_pspecs(jparams, jplan)
        jsan = jax_flat_specs(JPL.sanitize_pspecs(jspecs, jparams, m))
        jraw = jax_flat_specs(jspecs)
        specs = PL.param_pspecs(sds, plan)
        san = PL.sanitize_pspecs(specs, sds, m)
        for n, s in specs.items():
            path, idx = jax_path(n)
            lead = len(idx)
            assert jraw[path][:lead] == (None,) * lead, (n, jraw[path])
            assert _spec(s) == jraw[path][lead:], (arch, name, mesh, n)
            # the stacked leaf's lead axes stay whole, so sanitizing one
            # layer's leaf is sanitizing the stack's trailing dims
            assert _spec(san[n]) == jsan[path][lead:], (arch, name, mesh, n)
            assert tuple(sds[n].shape) == tuple(jflat[path].shape[lead:])
        # optimizer moments (factored for Kimi-K2)
        kw = dict(state_dtype=plan.opt_state_dtype,
                  factored=plan.opt_factored, momentum=plan.opt_momentum)
        jopt = jax.eval_shape(jax_make_optimizer("adamw", **kw).init,
                              jparams)
        jo = jax_flat_specs(JPL.opt_pspecs(jopt, jspecs, jplan))
        ost = make_optimizer(**kw).init(sds)
        ospecs = PL.opt_pspecs(ost, specs, plan)
        assert ospecs["count"] == jo["count"] == ()
        for n, st in ospecs["mu"].items():
            path, idx = jax_path(n)
            for tail, s in st.items():
                want = jo[f"mu/{path}/{tail}"]
                assert _spec(s) == want[len(idx):], (arch, name, n, tail)
                assert tuple(ost["mu"][n][tail].shape) == tuple(
                    jax_flat(jopt)[f"mu/{path}/{tail}"].shape[len(idx):])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_jax(arch, mesh):
    """batch_pspecs of every cell's inputs and cache_pspecs (sanitized) of
    every decode cell's cache, and the registry's input and cache specs'
    shapes and dtypes."""
    m = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        plan = PL.default_plan(cfg, shape, m)
        jplan = JPL.default_plan(jcfg, JAX_SHAPES[name], m)
        inputs = R.input_specs(cfg, shape)
        jinputs = JR.input_specs(jcfg, JAX_SHAPES[name])
        assert sorted(inputs) == sorted(jinputs)
        for k, v in inputs.items():
            assert tuple(v.shape) == jinputs[k].shape, (arch, name, k)
            assert str(v.dtype).removeprefix("torch.") == str(
                jinputs[k].dtype), (arch, name, k)
        assert {k: _spec(s) for k, s in PL.batch_pspecs(inputs, plan).items()
                } == {k: _spec(s) for k, s in JPL.batch_pspecs(
                    jinputs, jplan).items()}
        if shape.kind != "decode":
            continue
        cache = R.cache_specs(cfg, shape)
        jcache = JR.cache_specs(jcfg, JAX_SHAPES[name], JaxRuntime())
        jflat = jax_flat(jcache)
        flat = PL._leaves(cache)
        assert sorted(flat) == sorted(jflat)
        for k, v in flat.items():
            if k == "len":
                continue
            assert tuple(v.shape) == jflat[k].shape, (arch, name, k)
            assert str(v.dtype).removeprefix("torch.") == str(
                jflat[k].dtype), (arch, name, k)
        want = jax_flat_specs(JPL.sanitize_pspecs(
            JPL.cache_pspecs(jcache, jplan, jcfg, m), jcache, m))
        got = PL._leaves(PL.sanitize_pspecs(
            PL.cache_pspecs(cache, plan, cfg, m), cache, m))
        assert {k: _spec(s) for k, s in got.items()} == want, (arch, name,
                                                                mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_planview_candidates_and_estimates_equal_jax(arch, mesh):
    """PlanView.of on the mesh, the candidate plans field for field, and
    estimate on each candidate float for float, every shape."""
    m = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        cands = AP.candidate_plans(cfg, shape, m)
        jcands = JAP.candidate_plans(jcfg, JAX_SHAPES[name], m)
        assert [_fields(p) for p in cands] == [_fields(p) for p in jcands]
        for p, jp in zip(cands, jcands):
            assert dataclasses.asdict(CM.PlanView.of(p, m)) == \
                dataclasses.asdict(JCM.PlanView.of(jp, m))
            got = CM.estimate(cfg, shape, p, V5E_SPEC, mesh=m)
            want = JCM.estimate(jcfg, JAX_SHAPES[name], jp, m, V5E)
            for f in ("flops", "useful_flops", "hbm_bytes", "wire_bytes",
                      "hbm_capacity_bytes", "compute_s", "memory_s",
                      "collective_s"):
                assert getattr(got, f) == getattr(want, f), (name, p.name, f)


def test_placements_of_specs():
    """A spec's placements: Shard on each mesh dim an entry names,
    Replicate elsewhere, Partial where asked; a doubly named axis raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.models.runtime import placements

    class Named:
        mesh_dim_names = ("pod", "data", "model")
        ndim = 3
    m = Named()
    assert placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, "model"), m, partial="data") == (
        Replicate(), Partial(), Shard(1))
    with pytest.raises(ValueError, match="shards two dims"):
        placements(("model", "model"), m)
    np.testing.assert_equal(PL.sanitize_spec(("data", "model"), (3, 32),
                                             MESHES["2x2"]), (None, "model"))


class TypedMesh:
    """A 1 x 1 (data, model) mesh stand-in of one device type."""
    mesh_dim_names = ("data", "model")
    ndim = 2
    shape = {"data": 1, "model": 1}

    def __init__(self, device_type: str):
        self.device_type = device_type

    def size(self, dim: int) -> int:
        return 1


@pytest.mark.parametrize("entry", ["distribute", "distribute_model",
                                   "shard_batch", "make_mesh_spec",
                                   "make_host_mesh"])
def test_mesh_entry_points_refuse_another_device(entry):
    """Nothing moves a tensor between the host and a card on the way onto
    a mesh: a CPU tensor, model or batch raises on a cuda mesh (and the
    model keeps its plain parameters), and a mesh is a cuda one unless the
    caller asks for the CPU, so without a card building one raises."""
    import torch

    from repro_torch.launch import mesh as MESH
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.train_step import shard_batch
    mesh = TypedMesh("cuda")
    if entry in ("make_mesh_spec", "make_host_mesh"):
        if torch.cuda.is_available():
            pytest.skip("a card is visible: a cuda mesh is the default")
        with pytest.raises(RuntimeError, match="needs a visible CUDA card"):
            (MESH.make_mesh_spec(1, 1) if entry == "make_mesh_spec"
             else MESH.make_host_mesh(1))
        return
    with pytest.raises(ValueError, match="cpu tensor cannot go onto a "
                                         "cuda mesh"):
        if entry == "distribute":
            PL.distribute({"w": torch.zeros(2, 3)}, {"w": (None, "model")},
                          mesh)
        elif entry == "shard_batch":
            shard_batch({"tokens": torch.zeros(2, 4, dtype=torch.int32)},
                        Runtime(mesh=mesh, dp_axes=("data",),
                                tp_axis="model"))
        else:
            cfg = get_config("llama3.2-1b").reduced().replace(
                dtype="float32")
            model = R.get_model(cfg).init(torch.Generator().manual_seed(0))
            plan = PL.default_plan(cfg, SHAPES["train_4k"], mesh)
            try:
                PL.distribute_model(model, plan, mesh)
            finally:
                assert all(type(p) is torch.nn.Parameter
                           for p in model.parameters())
