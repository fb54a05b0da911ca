"""Parallelism plans: how an architecture is laid out on a mesh.

The PyTorch port of the JAX package's ``launch/plans.py``.  A
:class:`ParallelPlan` decides which mesh axes carry data, tensor and
expert parallelism, whether parameters are FSDP-sharded, the remat
policy, the MoE dispatch and the loss chunk; :func:`default_plan` is the
baseline plan of an (arch x shape x mesh) cell.  Without a mesh it takes
the one-device branches (remat a layer, groups of 4 for stacks of 32
layers or more, the loss in chunks of 512; Kimi-K2's optimizer state
factored, bf16 and momentum-free; a serving cell does neither remat nor
loss chunks), with a mesh the JAX package's.

The sharding rules are suffix-matched on parameter paths, the table of the
JAX package.  The port's per-layer parameters are a Python list
(``layers.3.attn.wq``), not a stack, so a rule is matched on the name's
JAX path (``models/convert.py::jax_path``) and padded to the port leaf's
own dims: the JAX package's stacked spec with its layer axes dropped.  A
spec is a tuple with one entry a tensor dim (an axis name, a tuple of
names, or ``None``); :func:`to_placements` turns one into DTensor
placements and :func:`distribute` puts tensors or a model's parameters on
a mesh with them.  The spec functions take anything whose ``.shape`` is a
mapping of axis to width (a ``DeviceMesh`` too, through
:func:`mesh_shape`), so they run without ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeSpec
from ..models.convert import jax_path
from ..models.runtime import Runtime, check_mesh_device, placements
from ..models.runtime import distribute as _distribute

Tree = Any


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: width} of a ``DeviceMesh`` or of a stand-in whose ``.shape``
    is already that mapping."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class ParallelPlan:
    name: str = "default"
    dp_axes: tuple[str, ...] = ("data",)     # batch axes
    tp_axis: str | None = "model"            # tensor parallelism
    fsdp_axes: tuple[str, ...] = ()          # ZeRO-3 param sharding axes
    ep_axis: str | None = None               # expert parallelism (MoE)
    moe_impl: str = "local"                  # local | ep | ep_a2a
    seq_shard_cache: bool = False            # shard KV cache on sequence
    remat: bool = True
    remat_group: int = 1                     # layers per remat block
    act_shard: str = "none"                  # none | seq (Megatron-SP style)
    loss_chunk: int = 512
    attn_mode: str = "auto"
    accum: int = 1                           # gradient-accumulation steps
    # optimizer memory policy (per-plan: the 1T cell needs factored+bf16)
    opt_state_dtype: str = "float32"
    opt_factored: bool = False
    opt_momentum: bool = True

    def runtime(self, mesh=None) -> Runtime:
        """The port's ``Runtime`` for this plan: on ``mesh`` with its axes,
        or without one on one device."""
        if mesh is None:
            return Runtime(attn_mode=self.attn_mode, remat=self.remat,
                           remat_group=self.remat_group,
                           loss_chunk=self.loss_chunk)
        axes = mesh_shape(mesh)
        return Runtime(
            mesh=mesh,
            dp_axes=tuple(a for a in self.dp_axes if a in axes),
            tp_axis=self.tp_axis,
            ep_axis=self.ep_axis or self.tp_axis,
            moe_impl=self.moe_impl,
            attn_mode=self.attn_mode,
            remat=self.remat,
            remat_group=self.remat_group,
            act_shard=self.act_shard,
            loss_chunk=self.loss_chunk,
        )


def default_plan(cfg: ModelConfig, shape: ShapeSpec,
                 mesh=None) -> ParallelPlan:
    """Baseline plan of an (arch x shape) cell: one device without a mesh,
    else the JAX package's branches on ``mesh``'s axes (ZeRO-3 for
    training; sequence-sharded activations past a 64 GB residual stream;
    grouped remat for deep stacks; the a2a MoE dispatch; FSDP for serving
    past 8 GB of bf16 weights)."""
    if mesh is None:
        return _one_device_plan(cfg, shape)
    axes = list(mesh_shape(mesh))
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    kw: dict = dict(name=f"{cfg.name}:{shape.name}:baseline",
                    dp_axes=dp, tp_axis=tp)
    if cfg.n_experts:
        kw.update(ep_axis=tp, moe_impl="ep_a2a")
    if shape.kind == "train":
        kw.update(fsdp_axes=dp)                       # ZeRO-3 default
        if tp and cfg.d_model * shape.tokens * 2 > 64e9:
            kw.update(act_shard="seq")                # big residual stream
        if cfg.n_layers >= 32:
            kw.update(remat_group=4)                  # deep stacks
    else:
        kw.update(remat=False, loss_chunk=0)
        if cfg.param_count() * 2 > 8e9:               # >8 GB of bf16 params
            kw.update(fsdp_axes=dp)                   # weights won't replicate
    if cfg.name == "kimi-k2-1t-a32b":
        kw.update(opt_factored=True, opt_state_dtype="bfloat16",
                  opt_momentum=False, fsdp_axes=dp)
        if shape.kind == "train":
            kw.update(act_shard="seq", remat_group=1)
    if shape.name == "long_500k":
        kw.update(dp_axes=(), seq_shard_cache=True)
    return ParallelPlan(**kw)


def _one_device_plan(cfg: ModelConfig, shape: ShapeSpec) -> ParallelPlan:
    kw: dict = dict(name=f"{cfg.name}:{shape.name}:baseline")
    if shape.kind == "train":
        if cfg.n_layers >= 32:
            kw.update(remat_group=4)                  # deep stacks
    else:
        kw.update(remat=False, loss_chunk=0)
    if cfg.name == "kimi-k2-1t-a32b":
        # 1T params: factored second moment, bf16 state, no momentum
        # buffer.  remat_group stays 1: grouped remat keeps g layers of
        # expert weights live in the group's backward
        kw.update(opt_factored=True, opt_state_dtype="bfloat16",
                  opt_momentum=False)
        if shape.kind == "train":
            kw.update(remat_group=1)
    return ParallelPlan(**kw)


# --------------------------------------------------------------------------
# parameter sharding rules (suffix-matched)
# --------------------------------------------------------------------------
# symbols: "tp" -> plan.tp_axis, "fsdp" -> plan.fsdp_axes, "ep" -> plan.ep_axis
_RULES: tuple[tuple[str, tuple], ...] = (
    ("embed/table", ("tp", "fsdp")),
    ("embed/pos", (None, None)),
    ("head/w", ("fsdp", "tp")),
    ("attn/wq", ("fsdp", "tp")),
    ("attn/wk", ("fsdp", "tp")),
    ("attn/wv", ("fsdp", "tp")),
    ("attn/wo", ("tp", "fsdp")),
    ("attn/bq", ("tp",)),
    ("attn/bk", ("tp",)),
    ("attn/bv", ("tp",)),
    ("moe/router", (None, None)),
    ("moe/wg", ("ep", "fsdp", None)),
    ("moe/wu", ("ep", "fsdp", None)),
    ("moe/wd", ("ep", "fsdp", None)),
    ("shared/wg", ("fsdp", "tp")),      # moe shared expert / zamba shared mlp
    ("shared/wu", ("fsdp", "tp")),
    ("shared/wd", ("tp", "fsdp")),
    ("mlp/wg", ("fsdp", "tp")),
    ("mlp/wu", ("fsdp", "tp")),
    ("mlp/wd", ("tp", "fsdp")),
    ("mlp/bu", ("tp",)),
    ("mlp/bd", (None,)),
    ("mixer/in_proj", ("fsdp", "tp")),
    ("mixer/conv_w", (None, "tp")),
    ("mixer/conv_b", ("tp",)),
    ("mixer/A_log", (None,)),
    ("mixer/dt_bias", (None,)),
    ("mixer/D", (None,)),
    ("mixer/out_proj", ("tp", "fsdp")),
    ("projector/w", (None, "fsdp")),
    ("projector/b", (None,)),
    ("adapter/w", (None, "fsdp")),
    ("enc_pos", (None, None)),
)


def _resolve(sym, plan: ParallelPlan):
    if sym is None:
        return None
    if sym == "tp":
        return plan.tp_axis
    if sym == "ep":
        return plan.ep_axis or plan.tp_axis
    if sym == "fsdp":
        return plan.fsdp_axes if plan.fsdp_axes else None
    raise KeyError(sym)


def spec_for(path_key: str, ndim: int, plan: ParallelPlan) -> tuple:
    """The spec of a leaf of ``ndim`` dims at JAX path ``path_key``."""
    for suffix, symbols in _RULES:
        if path_key.endswith(suffix):
            resolved = tuple(_resolve(s, plan) for s in symbols)
            pad = ndim - len(resolved)
            if pad < 0:
                resolved = resolved[-ndim:] if ndim else ()
                pad = 0
            return ((None,) * pad) + resolved
    return (None,) * ndim


def _leaves(tree: Tree, prefix: str = "") -> dict[str, Any]:
    """{"a/b/c": leaf} of nested dicts."""
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _nest(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *head, last = key.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def param_pspecs(params: Mapping[str, Any], plan: ParallelPlan) -> dict:
    """{name: spec} of the port's parameters ({name: tensor or anything
    with a ``.shape``}, e.g. ``model.named_parameters()``)."""
    return {n: spec_for(jax_path(n)[0], len(p.shape), plan)
            for n, p in dict(params).items()}


def opt_pspecs(opt_tree: Mapping, param_specs: Mapping,
               plan: ParallelPlan) -> dict:
    """Optimizer-state specs in ``AdamW.init``'s layout: the moments take
    their parameter's spec; the factored ``v_row`` drops its last dim,
    ``v_col`` its second to last; ``count`` is replicated."""
    mu = {}
    for name, st in opt_tree["mu"].items():
        pkey = jax_path(name)[0]
        out = {}
        for tail, leaf in st.items():
            pad = 1 if tail in ("v_row", "v_col") else 0
            base = spec_for(pkey, len(leaf.shape) + pad, plan)
            if tail == "v_row":
                out[tail] = base[:-1]
            elif tail == "v_col":
                out[tail] = base[:-2] + base[-1:]
            else:
                out[tail] = base
        mu[name] = out
    return {"mu": mu, "count": ()}


def batch_pspecs(batch: Mapping, plan: ParallelPlan) -> dict:
    """Every batch leaf's rows over the dp axes."""
    dp = plan.dp_axes

    def one(leaf):
        if not dp:
            return (None,) * len(leaf.shape)
        return (dp,) + (None,) * (len(leaf.shape) - 1)
    return _nest({k: one(v) for k, v in _leaves(batch).items()})


def cache_pspecs(cache: Mapping, plan: ParallelPlan, cfg: ModelConfig,
                 mesh=None) -> dict:
    """KV/SSM cache specs: batch over dp, kv heads over tp (the sequence
    over tp where the kv heads do not divide its width); the sequence over
    ``data`` where the plan says so (long-context, batch-1 cells)."""
    dp, tp = plan.dp_axes, plan.tp_axis
    tp_size = mesh_shape(mesh)[tp] if (mesh is not None and tp) else 1

    def heads_divide(n: int) -> bool:
        return tp is not None and n and n % max(tp_size, 1) == 0

    def one(key, leaf):
        nd = len(leaf.shape) if hasattr(leaf, "shape") else 0
        if key == "len":
            return ()
        if key == "enc_out":                      # (B, S_enc, D)
            seq = ("data",) if plan.seq_shard_cache else None
            return (dp or None, seq, None)
        if key in ("k", "v", "shared_k", "shared_v"):
            seq = ("data",) if plan.seq_shard_cache else None
            if heads_divide(cfg.n_kv_heads):
                return (None, dp or None, seq, tp, None)
            if seq is None:
                return (None, dp or None, tp, None, None)
            if heads_divide(cfg.head_dim):
                return (None, dp or None, seq, None, tp)
            return (None, dp or None, seq, None, None)
        if key.endswith("conv"):                  # (L.., B, K-1, C)
            pad = nd - 3
            ctp = tp if heads_divide(leaf.shape[-1]) else None
            return (None,) * pad + (dp or None, None, ctp)
        if key.endswith("ssm"):                   # (L.., B, H, P, N)
            pad = nd - 4
            htp = tp if heads_divide(cfg.n_ssm_heads) else None
            return (None,) * pad + (dp or None, htp, None, None)
        return (None,) * nd
    return _nest({k: one(k, v) for k, v in _leaves(cache).items()})


def sanitize_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop the sharding of any dim the mesh axes do not divide evenly."""
    widths = mesh_shape(mesh)

    def size(a) -> int:
        if a is None:
            return 1
        if isinstance(a, (tuple, list)):
            n = 1
            for x in a:
                n *= widths[x]
            return n
        return widths[a]
    nd = len(shape)
    dims = (tuple(spec) + (None,) * nd)[:nd]
    return tuple(d if shape[i] % size(d) == 0 else None
                 for i, d in enumerate(dims))


def sanitize_pspecs(specs: Mapping, tree: Mapping, mesh) -> dict:
    """:func:`sanitize_spec` over matching trees of specs and leaves."""
    leaves = _leaves(tree)
    return _nest({k: sanitize_spec(s, getattr(leaves[k], "shape", ()), mesh)
                  for k, s in _leaves(specs).items()})


# --------------------------------------------------------------------------
# specs -> DTensor placements
# --------------------------------------------------------------------------
def to_placements(specs, mesh):
    """A spec, or a tree of them, as DTensor placements on ``mesh``."""
    if isinstance(specs, Mapping):
        return {k: to_placements(v, mesh) for k, v in specs.items()}
    return placements(specs, mesh)


def distribute(tree, specs, mesh):
    """Tensors (a dict tree) as DTensors on ``mesh`` with their specs.
    Every rank holds the same full tensors (made from the same seed or
    read from the same file), so each takes its own shard of its copy:
    nothing is sent.  A tensor on another device type than the mesh's
    raises (``runtime.distribute``)."""
    if isinstance(tree, Mapping):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return _distribute(tree, mesh, placements(specs, mesh))


def distribute_model(model: nn.Module, plan: ParallelPlan, mesh) -> dict:
    """Replace ``model``'s parameters, in place, by DTensors on ``mesh``
    with their sanitized specs (``requires_grad`` kept).  Returns the
    {name: spec} it used.  A model on another device type than the
    mesh's raises before any parameter is replaced."""
    named = dict(model.named_parameters())
    specs = {n: sanitize_spec(s, named[n].shape, mesh)
             for n, s in param_pspecs(named, plan).items()}
    for p in named.values():
        check_mesh_device(p, mesh)
    for mname, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            full = f"{mname}.{pname}" if mname else pname
            mod._parameters[pname] = nn.Parameter(
                distribute(p.detach(), specs[full], mesh),
                requires_grad=p.requires_grad)
    return specs
