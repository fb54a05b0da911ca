"""The port's step model (``repro_torch.gpu.cost_model``, ``autoplan``,
``repro_torch.roofline``) against the JAX package's on the CPU, and the JAX
tests' properties where one H100 makes them meaningful.

On a ``ChipSpec`` carrying the v5e's figures, the port's ``estimate_view``
equals ``repro.tpu.cost_model.estimate`` float for float on every arch ×
shape × mesh, each ``PlanView`` built by the JAX package from its default
plan; the port's one-device ``rank`` equals the JAX ``rank`` on a
one-device mesh once the plans that differ only in axes of width 1 are
taken out.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.launch.plans import default_plan as jax_default_plan
from repro.roofline import analysis as jax_analysis
from repro.roofline import constants as jax_constants
from repro.tpu.autoplan import rank as jax_rank
from repro.tpu.chip import V5E
from repro.tpu.cost_model import PlanView as JaxPlanView
from repro.tpu.cost_model import estimate as jax_estimate
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.gpu.autoplan import candidate_plans, rank
from repro_torch.gpu.chip import H100, ChipSpec
from repro_torch.gpu.cost_model import PlanView, estimate, estimate_view
from repro_torch.gpu.op_walk import OpWalk
from repro_torch.launch.plans import default_plan
from repro_torch.models.registry import get_model
from repro_torch.models.runtime import Runtime
from repro_torch.roofline import analysis, constants
from torch_threads import one_torch_thread  # noqa: F401

#: the port's chip spec with the JAX package's v5e figures
V5E_SPEC = ChipSpec(name=V5E.name, peak_flops_bf16=V5E.peak_flops_bf16,
                    hbm_bytes_per_s=V5E.hbm_bytes_per_s,
                    hbm_capacity=V5E.hbm_capacity,
                    link_bytes_per_s=V5E.ici_link_bytes_per_s,
                    links=V5E.ici_links, mma_tile=V5E.mxu_tile)
MESHES = {"one": {"data": 1}, "pod": {"data": 16, "model": 16},
          "two_pods": {"pod": 2, "data": 16, "model": 16}}


class MeshView:
    """A mesh's shape, all the JAX cost model reads of a mesh."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_estimate_equals_jax_on_every_shape(arch, mesh):
    m = MeshView(MESHES[mesh])
    for name in SHAPES:
        jcfg, jshape = jax_config(arch), JAX_SHAPES[name]
        jplan = jax_default_plan(jcfg, jshape, m)
        want = jax_estimate(jcfg, jshape, jplan, m, V5E)
        view = PlanView(**dataclasses.asdict(JaxPlanView.of(jplan, m)))
        got = estimate_view(get_config(arch), SHAPES[name], view, V5E_SPEC)
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (name, f.name)
        assert dict(got.parts) == dict(want.parts)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_equals_jax_on_one_device(arch):
    """The JAX candidates on a one-device mesh repeat each (remat,
    remat_group, loss_chunk) over FSDP, sequence sharding and the MoE
    dispatch, which have width 1 there; the first of each, in the JAX
    order, is the port's plan."""
    m = MeshView({"data": 1})
    want, seen = [], set()
    for r in jax_rank(jax_config(arch), JAX_SHAPES["train_4k"], m, V5E):
        key = (r.plan.remat, r.plan.remat_group, r.plan.loss_chunk)
        if key not in seen:
            seen.add(key)
            want.append((key, dataclasses.asdict(r.est)))
    got = [((r.plan.remat, r.plan.remat_group, r.plan.loss_chunk),
            dataclasses.asdict(r.est))
           for r in rank(get_config(arch), SHAPES["train_4k"], V5E_SPEC)]
    assert got == want
    assert len(got) == 15


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equals_jax(arch):
    for name in SHAPES:
        assert analysis.model_flops(arch, name) == \
            jax_analysis.model_flops(arch, name)


def test_estimate_of_a_port_plan_is_one_device():
    """``estimate`` of the port's default plan is ``estimate_view`` at
    width 1 everywhere: the JAX package's one-device mesh."""
    m = MeshView({"data": 1})
    for arch in ("llama3.2-1b", "granite-moe-1b-a400m"):
        for name in SHAPES:
            cfg = get_config(arch)
            got = estimate(cfg, SHAPES[name], default_plan(cfg, SHAPES[name]),
                           V5E_SPEC)
            jplan = jax_default_plan(jax_config(arch), JAX_SHAPES[name], m)
            want = jax_estimate(jax_config(arch), JAX_SHAPES[name], jplan, m,
                                V5E)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def walked_record():
    """A record of a walked reduced Llama prefill, in the dry-run layout,
    filed as Llama-3.2-1B's ``prefill_32k`` cell."""
    cfg = get_config("llama3.2-1b").reduced().replace(dtype="float32")
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    with OpWalk() as walk:
        api.prefill(model, tokens, Runtime(attn_mode="chunked"))
    return analysis.cell_record(
        "llama3.2-1b__prefill_32k__1xH100", "llama3.2-1b", "prefill_32k",
        "prefill", walk.costs(),
        {"argument_size_in_bytes": 3 * 2**30, "temp_size_in_bytes": 2**30})


def test_analyze_cell_equals_jax_on_a_walked_record(walked_record):
    got = analysis.analyze_cell(walked_record)
    want = jax_analysis.analyze_cell(walked_record)
    assert got.model_flops == want.model_flops
    assert got.useful_ratio == want.useful_ratio
    assert got.hlo_flops_per_dev == want.hlo_flops_per_dev > 0
    assert got.n_dev == want.n_dev == 1
    assert got.compute_s * constants.PEAK_BF16 == pytest.approx(
        want.compute_s * jax_constants.PEAK_BF16, rel=1e-15)
    assert got.memory_s * constants.HBM_BW == pytest.approx(
        want.memory_s * jax_constants.HBM_BW, rel=1e-15)
    assert got.collective_s == want.collective_s == 0.0
    assert (got.hbm_args_gib, got.hbm_temp_gib) == (3.0, 1.0)
    assert got.recommendation == analysis._RECS[got.dominant]


def test_analyze_cell_takes_a_cut_shape(walked_record):
    rec = dict(walked_record, shape_cut={"seq_len": 48, "global_batch": 2})
    cfg = get_config("llama3.2-1b")
    assert analysis.analyze_cell(rec).model_flops == \
        2.0 * cfg.param_count() * 48 * 2


def test_load_artifacts_filters(tmp_path, walked_record):
    good = walked_record
    recs = {"good": good, "failed": dict(good, ok=False),
            "other_mesh": dict(good, mesh="single"),
            "tagged": dict(good, cell=good["cell"] + "__hillclimb")}
    for name, rec in recs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    (tmp_path / "notes.txt").write_text("not a record")
    assert analysis.load_artifacts(str(tmp_path), "1xH100") == [good]
    both = analysis.load_artifacts(str(tmp_path))
    assert both == [good, recs["other_mesh"]]
    assert both == jax_analysis.load_artifacts(str(tmp_path))
    assert analysis.load_artifacts(str(tmp_path / "missing")) == []


def test_dtype_bound_prices_each_dtype_at_its_rate():
    got = analysis.dtype_bound_s({"bfloat16": 989e12, "float32": 67e12})
    assert got == pytest.approx(2.0, rel=1e-15)


# ---- the JAX tests' properties (tests/test_tpu_model.py) on one H100 ----
def test_h100_terms_positive_and_fit_flags():
    cfg, shape = get_config("llama3.2-1b"), SHAPES["train_4k"]
    est = estimate(cfg, shape, default_plan(cfg, shape))
    assert est.flops > 0 and est.hbm_bytes > 0 and est.compute_s > 0
    assert est.wire_bytes == 0.0 and est.collective_s == 0.0  # one card
    assert 0 < est.mxu_utilization <= 1.0
    small = dataclasses.replace(shape, global_batch=4)
    assert estimate(cfg, small, default_plan(cfg, small)).fits


def test_h100_decode_is_memory_bound_dense():
    cfg, shape = get_config("qwen2.5-32b"), SHAPES["decode_32k"]
    assert estimate(cfg, shape, default_plan(cfg, shape)).dominant() \
        == "memory"


def test_h100_tile_padding_penalizes_head_dim_80():
    """Eq. 1 analog: a head dim of 80 (danube) fills 80 of the 128 lanes
    of two 64-wide tensor-core tiles; 128 fills both."""
    assert H100.mma_pad(80) == 128 and H100.mma_pad(128) == 128
    s = SHAPES["train_4k"]
    cfg80, cfg128 = get_config("h2o-danube-1.8b"), get_config("qwen2.5-32b")
    e80 = estimate(cfg80, s, default_plan(cfg80, s))
    e128 = estimate(cfg128, s, default_plan(cfg128, s))
    assert e80.mxu_utilization < e128.mxu_utilization


def test_h100_autoplan_prefers_feasible_and_orders_by_step():
    cfg = get_config("llama3.2-1b")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4)
    ranked = rank(cfg, shape)
    assert len(ranked) == len(candidate_plans(cfg, shape)) == 15
    fits = [r.est.fits for r in ranked]
    assert fits == sorted(fits, reverse=True) and any(fits)
    steps = [r.step_s for r in ranked if r.est.fits]
    assert steps == sorted(steps)
    assert candidate_plans(cfg, SHAPES["decode_32k"]) == [
        default_plan(cfg, SHAPES["decode_32k"])]


def test_h100_kimi_does_not_fit_one_card():
    cfg = get_config("kimi-k2-1t-a32b")
    for name in ("train_4k", "decode_32k"):
        est = estimate(cfg, SHAPES[name], default_plan(cfg, SHAPES[name]))
        assert not est.fits
        assert est.hbm_capacity_bytes > 10 * H100.hbm_capacity
