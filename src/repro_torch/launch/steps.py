"""Step builders: (arch x shape x mesh x plan) -> a step that runs there.

The PyTorch port of the JAX package's ``launch/steps.py``: one place that
assembles a distributed train, prefill or decode step from the model API,
the optimizer and the plan's shardings.  Where the JAX package returns a
jitted function with its ``in_shardings``, the port returns the step as a
Python function over DTensors (the port has no jit, so there is no
``lower()``: ``launch/dryrun.py`` runs the step on ``meta`` tensors in its
place): ``arg_specs`` are ``models/registry.py``'s meta-tensor stand-ins
and ``in_shardings`` their DTensor placements (``launch/plans.py``).
Every rank calls the step with the same full inputs (the same seed, the
same batch) or with DTensors already placed; :meth:`BuiltStep.place_model`
puts a model's parameters on the mesh, :func:`place_cache` a cache.

Shape convention: ``decode_*`` / ``long_*`` cells run ``decode_step``
(one new token against a KV cache of ``seq_len``), ``prefill_*`` cells the
prompt pass, ``train_*`` cells a train step, for every family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models import registry as model_registry
from ..models.runtime import Runtime, placements
from ..train.optimizer import AdamW, make_optimizer
from ..train.train_step import make_train_step, shard_batch
from . import plans as PL


@dataclass
class BuiltStep:
    """A step plus the specs and placements of its arguments."""

    kind: str                  # train | prefill | decode
    fn: Callable
    arg_specs: tuple           # meta-tensor trees, positional
    in_shardings: tuple        # DTensor placement trees, positional
    plan: PL.ParallelPlan
    rt: Runtime
    cfg: ModelConfig
    shape: ShapeSpec
    opt: AdamW | None = None

    def place_model(self, model):
        """``model``'s parameters as DTensors on the mesh, in place, with
        the plan's sanitized specs; returns the model."""
        PL.distribute_model(model, self.plan, self.rt.mesh)
        return model


def make_optimizer_for(plan: PL.ParallelPlan, cfg: ModelConfig) -> AdamW:
    return make_optimizer("adamw", state_dtype=plan.opt_state_dtype,
                          factored=plan.opt_factored,
                          momentum=plan.opt_momentum)


def place_cache(cache: dict, specs: dict, mesh) -> dict:
    """A cache (a dict tree; ``len`` an int) with every tensor on its spec
    of ``specs`` on ``mesh``: a DTensor redistributed there, a plain
    tensor (the same on every rank) distributed without a send."""
    from torch.distributed.tensor import DTensor

    from ..models.runtime import distribute
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = place_cache(v, specs[k], mesh)
        elif isinstance(v, DTensor):
            out[k] = v.redistribute(mesh, placements(specs[k], mesh))
        elif isinstance(v, torch.Tensor):
            out[k] = distribute(v, mesh, placements(specs[k], mesh))
        else:
            out[k] = v
    return out


def cache_specs_of(cache: dict, plan: PL.ParallelPlan, cfg: ModelConfig,
                   mesh) -> dict:
    """The sanitized specs of a cache's leaves (``plans.cache_pspecs``)."""
    return PL.sanitize_pspecs(PL.cache_pspecs(cache, plan, cfg, mesh),
                              cache, mesh)


def _param_specs(cfg, plan, mesh) -> tuple[dict, dict]:
    sds = model_registry.param_specs(cfg)
    specs = {n: PL.sanitize_spec(s, sds[n].shape, mesh)
             for n, s in PL.param_pspecs(sds, plan).items()}
    return sds, specs


def build_train(cfg: ModelConfig, shape: ShapeSpec, mesh,
                plan: PL.ParallelPlan | None = None, *,
                opt: AdamW | None = None) -> BuiltStep:
    """step(state, batch) -> (state, metrics) on ``mesh``: the state's
    model placed by :meth:`BuiltStep.place_model`, its optimizer state
    made after that (``opt.init`` takes the parameters' placements)."""
    plan = plan or PL.default_plan(cfg, shape, mesh)
    rt = plan.runtime(mesh)
    api = model_registry.get_model(cfg)
    opt = opt or make_optimizer_for(plan, cfg)
    step = make_train_step(api, rt, opt, accum=plan.accum,
                           device=mesh.device_type)
    params_sds, p_specs = _param_specs(cfg, plan, mesh)
    batch_sds = model_registry.input_specs(cfg, shape)
    b_specs = PL.batch_pspecs(batch_sds, plan)
    in_sh = (PL.to_placements(p_specs, mesh), PL.to_placements(b_specs, mesh))
    return BuiltStep("train", step, (params_sds, batch_sds), in_sh, plan, rt,
                     cfg, shape, opt)


def build_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  plan: PL.ParallelPlan | None = None) -> BuiltStep:
    """fn(model, batch, max_len=None) -> (last logits, cache): every
    cache leaf on ``cache_pspecs``' placements, ready for the decode
    step."""
    plan = plan or PL.default_plan(cfg, shape, mesh)
    rt = plan.runtime(mesh)
    api = model_registry.get_model(cfg)
    params_sds, p_specs = _param_specs(cfg, plan, mesh)
    batch_sds = model_registry.input_specs(cfg, shape)
    b_specs = PL.batch_pspecs(batch_sds, plan)

    def prefill_fn(model, batch, max_len=None):
        batch = shard_batch(dict(batch), rt)
        logits, cache = api.prefill(model, batch, rt, max_len=max_len)
        return logits, place_cache(cache, cache_specs_of(cache, plan, cfg,
                                                         mesh), mesh)
    in_sh = (PL.to_placements(p_specs, mesh), PL.to_placements(b_specs, mesh))
    return BuiltStep("prefill", prefill_fn, (params_sds, batch_sds), in_sh,
                     plan, rt, cfg, shape)


def build_decode(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 plan: PL.ParallelPlan | None = None) -> BuiltStep:
    """fn(model, cache, tokens) -> (logits, cache): one new token against
    a KV cache of ``seq_len``, the cache updated in place on its
    placements.  ``tokens`` (B, 1), the same on every rank or a DTensor."""
    plan = plan or PL.default_plan(cfg, shape, mesh)
    rt = plan.runtime(mesh)
    api = model_registry.get_model(cfg)
    params_sds, p_specs = _param_specs(cfg, plan, mesh)
    cache_sds = model_registry.cache_specs(cfg, shape, rt)
    c_specs = cache_specs_of(cache_sds, plan, cfg, mesh)
    tok_sds = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                          device="meta")
    t_spec = (plan.dp_axes or None, None)

    def decode_fn(model, cache, tokens):
        tokens = shard_batch({"tokens": tokens}, rt)["tokens"]
        return api.decode_step(model, cache, tokens, rt)
    in_sh = (PL.to_placements(p_specs, mesh), PL.to_placements(c_specs, mesh),
             placements(t_spec, mesh))
    return BuiltStep("decode", decode_fn, (params_sds, cache_sds, tok_sds),
                     in_sh, plan, rt, cfg, shape)


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
               plan: PL.ParallelPlan | None = None, **kw: Any) -> BuiltStep:
    """Dispatch on the cell kind (train / prefill / decode)."""
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, plan, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, plan)
    return build_decode(cfg, shape, mesh, plan)
