"""The port's LM mesh run on the cases of ``golden_mesh.npz``.

A rank program: each rank joins a gloo process group, builds the reduced
f32 Llama and Granite MoE with the params the golden file names, and runs
the mesh routes on its cases, rank 0 writing what they return to an
``.npz`` file for a caller to hold against the golden values
(``tests/test_torch_mesh.py`` on the CPU; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 20 on the card, the ranks sharing it).
Nothing here compares: it only runs the port.  It imports the port
alone, never ``jax`` or the JAX package.

On a 2 x 2 (data, model) mesh (world 4), per arch (``<arch>/``):

* ``train/<plan>/{loss,nll,aux}`` and ``train/<plan>/grads/<path>``: the
  loss and gradients under each golden plan (``tp_dp``, ZeRO-3 ``fsdp``,
  ``seq``; the chunked attention), the gradients in the JAX layout;
* ``step/{loss,grad_norm}``, ``step/params/<path>``: one
  ``launch.steps.build_train`` step of the first plan (``tp_dp``);
* ``prefill/logits``, ``decode/tokens``, ``decode/logits0``: prefill with
  a cache of ``new`` more positions on ``cache_pspecs``' placements
  (``cache_placements``) and ``new`` greedy decode steps;
* ``compress/grads``, ``compress/residuals/<shard>``, ``compress/scales``
  and ``compress/losses``: the int8 compressed step over ``data``;
* Granite's ``moe/<impl>/{y,aux,dropped,collectives}``: ``moe_ep`` and
  ``moe_ep_a2a`` on the golden input, the assignments each drops, and
  the collectives each ran (count and bytes by kind, JSON); ``local`` on
  the mesh and ``moe_local`` on one device (``moe/local_plain``).

On a 1 x 4 mesh, where the reduced Llama's heads do not divide the 4-wide
model axis, ``odd/<case>/mesh/``: the golden file's ``odd_heads`` cases
on their golden params (``kv``: 2 kv heads repeated to 4 in prefill,
the decode cache sharded on its sequence; ``pad``: 6 heads of 16 padded
to 8), each with prefill's logits, greedy decode and a loss with its
gradients, as the 2 x 2 keys.  Also ``reshard/4x1/<name>`` (that step's
checkpoint saved on 2 x 2 and restored onto a 4 x 1 mesh through
``restore(..., shardings=)``) and ``modules/bad`` (any ``jax`` or
``repro`` module in a rank's ``sys.modules``).  On a 1 x 1 mesh (world 1)
the same routes beside the unsharded ones (``one/<route>/{mesh,plain}``)
and the restore onto 1 x 1 into a state already placed there
(``reshard/1x1/<name>``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "data")
GOLDEN_MESH = os.path.join(DATA, "golden_mesh.npz")
ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")


def golden() -> dict:
    with np.load(GOLDEN_MESH) as z:
        return {k: z[k] for k in z.files}


def model_of(g: dict, arch: str, device):
    """The reduced f32 config and the port's model holding the golden
    file's params of ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import from_jax, unflatten
    cfg = get_config(arch).reduced().replace(dtype="float32")
    pre = f"{arch}/"
    with np.load(os.path.join(DATA, str(g[pre + "params_file"]))) as z:
        params = unflatten({k: z[k] for k in z.files},
                           str(g[pre + "params_prefix"]))
    return cfg, from_jax(params, cfg, device)


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _jax_tree(named: dict, prefix: str) -> dict:
    """{name: tensor} -> {prefix + JAX path: array}, per-layer stacked."""
    from repro_torch.models.convert import flatten, to_jax
    return flatten(to_jax({k: torch.from_numpy(_np(v))
                           for k, v in named.items()}), prefix)


def _batch(g: dict, arch: str, device) -> dict:
    return {k: torch.from_numpy(g[f"{arch}/batch/{k}"]).to(device)
            for k in ("tokens", "labels")}


def _cfg(g: dict) -> dict:
    return json.loads(str(g["config"]))


def _plans(cfg, shape, mesh, conf):
    from repro_torch.launch import plans as PL
    base = dataclasses.replace(PL.default_plan(cfg, shape, mesh),
                               attn_mode="chunked")
    names = conf["plans"] if cfg.family == "dense" else {
        k: conf["plans"][k] for k in conf["moe_plans"]}
    return base, {n: dataclasses.replace(base, **{
        k: tuple(v) if isinstance(v, list) else v for k, v in ov.items()})
        for n, ov in names.items()}


def _greedy(cfg, mesh, shape, model, tokens, new: int, out: dict, pre: str):
    """Prefill and ``new`` greedy decode steps on ``mesh`` under the
    serving plan (the chunked attention), as the golden run."""
    from repro_torch.launch import plans as PL
    from repro_torch.launch import steps as ST
    plan = dataclasses.replace(PL.default_plan(cfg, shape, mesh),
                               attn_mode="chunked")
    prefill = ST.build_prefill(cfg, shape, mesh, plan)
    decode = ST.build_decode(cfg, dataclasses.replace(
        shape, kind="decode", seq_len=shape.seq_len + new), mesh, plan)
    prefill.place_model(model)
    logits, cache = prefill.fn(model, {"tokens": tokens},
                               max_len=shape.seq_len + new)
    out[pre + "prefill/logits"] = _np(logits)[:, -1]
    out[pre + "cache_placements"] = np.array(str(tuple(
        cache["k"].placements)))
    tok = logits.full_tensor()[:, -1, :cfg.vocab_size].argmax(-1)
    toks = []
    for i in range(new):
        toks.append(tok.cpu().numpy())
        logits, cache = decode.fn(model, cache, tok[:, None].int())
        full = logits.full_tensor()
        if i == 0:
            out[pre + "decode/logits0"] = _np(full)[:, -1]
        tok = full[:, -1, :cfg.vocab_size].argmax(-1)
    out[pre + "decode/tokens"] = np.stack(toks, 1).astype(np.int32)


def _compressed(g, arch, cfg, mesh, device, conf, out):
    """The compressed step over data: the first step's averaged gradients,
    residuals (per data shard) and scales, then the losses of the
    golden's count of steps."""
    import torch.distributed as dist

    from repro_torch.models import collectives as C
    from repro_torch.models import registry as R
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (compressed_grads, init_residuals,
                                    init_state, make_compressed_train_step)
    from repro_torch.configs.base import ShapeSpec
    pre = f"{arch}/"
    S, B = conf["shape"]
    shape = ShapeSpec("mesh", "train", S, B)
    api = R.get_model(cfg)
    plan, _ = _plans(cfg, shape, mesh, conf)
    crt = dataclasses.replace(plan.runtime(None), attn_mode="chunked")
    _, model = model_of(g, arch, device)
    model.requires_grad_(True)
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    batch = _batch(g, arch, device)
    mb = {k: v[r * (B // n):(r + 1) * (B // n)] for k, v in batch.items()}
    names, params = zip(*model.named_parameters())
    loss, _ = api.loss(model, mb, crt)
    gs = torch.autograd.grad(loss, params)
    means, res = compressed_grads(dict(zip(names, gs)),
                                  init_residuals(model), mesh=mesh,
                                  axis="data", n_shards=n)
    out.update(_jax_tree(means, pre + "compress/grads/"))
    # one shared scale a JAX leaf: the max over its layers and the shards
    for path, a in _jax_tree(dict(zip(names, gs)), "").items():
        m = C.all_reduce(torch.tensor(float(np.abs(a).max())), "max", mesh,
                         "data")
        out[f"{pre}compress/scales/{path}"] = _np(m / 127.0 + 1e-30)
    shards = [None] * dist.get_world_size()
    mine = _jax_tree(res, "") if mesh.get_local_rank("model") == 0 else None
    dist.all_gather_object(shards, (r, mine))
    for rr, tree in shards:
        if tree is not None:
            out.update({f"{pre}compress/residuals/{rr}/{k}": v
                        for k, v in tree.items()})
    # the launcher's loop
    opt = make_optimizer("adamw", **conf["compress_opt"])
    _, model = model_of(g, arch, device)
    step = make_compressed_train_step(api, crt, opt, mesh=mesh, axis="data",
                                      n_shards=n, device=device)
    state = init_state(api, opt, model=model, device=device)
    residuals = init_residuals(model)
    losses = []
    for i in range(conf["compress_steps"]):
        b = {k: g[f"{pre}compress/batch/{i}/{k}"] for k in ("tokens",
                                                            "labels")}
        state, residuals, met = step(state, residuals, b)
        losses.append(float(met["loss"]))
    out[pre + "compress/losses"] = np.asarray(losses, np.float32)


def _moe(g, cfg, model, mesh, out, pre):
    """moe_ep and moe_ep_a2a through ``moe_fwd`` on the golden input, the
    assignments each one's shards drop past their capacity, and ``local``
    on the mesh beside ``moe_local`` on one device (``local_plain``)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe as M
    from repro_torch.models.collectives import CollectiveCounter
    from repro_torch.models.runtime import Runtime, placements
    from repro_torch.models.transformer import mesh_context
    from repro_torch.launch import plans as PL
    lp = model["layers"][0]["moe"]
    x = torch.from_numpy(g[pre + "moe/x"]).to(lp["router"].device)
    B, S, _ = x.shape
    with torch.no_grad():
        y, aux = M.moe_local(lp, x, cfg)
    out[f"{pre}moe/local_plain/y"], out[f"{pre}moe/local_plain/aux"] = \
        _np(y), _np(aux)
    for impl in ("ep", "ep_a2a", "local"):
        rt = Runtime(mesh=mesh, dp_axes=("data",), tp_axis="model",
                     ep_axis="model", moe_impl=impl)
        spec = ("data", "model" if impl == "ep_a2a" else None, None)
        dx = distribute_tensor(x, mesh, placements(spec, mesh),
                               src_data_rank=None)
        params = {}
        for k in ("router", "wg", "wu", "wd"):
            s = PL.spec_for(f"moe/{k}", lp[k].ndim, PL.ParallelPlan(
                ep_axis="model"))
            params[k] = distribute_tensor(lp[k].detach(), mesh,
                                          placements(s, mesh),
                                          src_data_rank=None)
        with torch.no_grad(), mesh_context(rt), CollectiveCounter() as cc:
            y, aux = M.moe_fwd(params, dx, cfg, rt)
            y, aux = _np(y), _np(aux)
        out[f"{pre}moe/{impl}/y"] = y
        out[f"{pre}moe/{impl}/aux"] = aux
        out[f"{pre}moe/{impl}/collectives"] = np.array(json.dumps(
            cc.report()))
        if impl == "local":
            continue
        # the drops, shard by shard, by the local route's own order
        nd, nm = 2, 2
        dropped = 0
        for d in range(nd):
            xs = x[d * (B // nd):(d + 1) * (B // nd)]
            parts = ([xs[:, m * (S // nm):(m + 1) * (S // nm)]
                      for m in range(nm)] if impl == "ep_a2a" else [xs])
            for xp in parts:
                xf = xp.reshape(-1, xp.shape[-1])
                eidx, _, _ = M._route(xf, lp["router"], cfg)
                pos = M._rank_in_expert(eidx.reshape(-1))
                dropped += int((pos >= M._capacity(xf.shape[0], cfg)).sum())
        out[f"{pre}moe/{impl}/dropped"] = np.asarray(dropped)


def run_2x2(g: dict, device: str, ckpt_dir: str) -> dict:
    """The world-4 cases (module docstring)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry as R
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_state, value_and_grads
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import plans as PL
    from repro_torch.launch import steps as ST
    conf = _cfg(g)
    mesh = MESH.make_mesh_spec(2, 2, device=device)
    S, B = conf["shape"]
    shape = ShapeSpec("mesh", "train", S, B)
    out: dict = {}
    for arch in ARCHS:
        pre = f"{arch}/"
        cfg, _ = model_of(g, arch, device)
        api = R.get_model(cfg)
        batch = _batch(g, arch, device)
        base, plans = _plans(cfg, shape, mesh, conf)
        for name, plan in plans.items():
            _, model = model_of(g, arch, device)
            PL.distribute_model(model, plan, mesh)
            model.requires_grad_(True)
            loss, met, grads = value_and_grads(api, plan.runtime(mesh),
                                               model, batch)
            tp = f"{pre}train/{name}/"
            out.update({tp + "loss": _np(loss), tp + "nll": _np(met["nll"]),
                        tp + "aux": _np(met["aux"])})
            out.update(_jax_tree(grads, tp + "grads/"))
        first = next(iter(plans.values()))
        built = ST.build_train(cfg, shape, mesh, first)
        model = built.place_model(model_of(g, arch, device)[1])
        state = init_state(api, built.opt, model=model, device=device)
        state, met = built.fn(state, batch)
        out.update({pre + "step/loss": _np(met["loss"]),
                    pre + "step/grad_norm": _np(met["grad_norm"])})
        out.update(_jax_tree(dict(model.named_parameters()),
                             pre + "step/params/"))
        if arch == ARCHS[0]:
            d = os.path.join(ckpt_dir, "2x2")
            ckpt.save(d, 1, state, extra={"mesh": PL.mesh_shape(mesh)})
            out.update(_reshard(cfg, api, built.opt, d, (4, 1), device,
                                first, "4x1", shardings=True))
        _, model = model_of(g, arch, device)
        _greedy(cfg, mesh, ShapeSpec("mesh", "prefill", S, B), model,
                batch["tokens"], conf["new"], out, pre)
        _compressed(g, arch, cfg, mesh, device, conf, out)
        if cfg.n_experts:
            _moe(g, cfg, model_of(g, arch, device)[1], mesh, out, pre)
    _odd_heads(g, device, out)
    return out


def _odd_heads(g: dict, device: str, out: dict) -> None:
    """Heads that do not divide the model axis (module docstring): each
    case's mesh route on a 1 x 4 mesh, on its golden params."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry as R
    from repro_torch.models.convert import from_jax, unflatten
    from repro_torch.train.train_step import value_and_grads
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import plans as PL
    mesh = MESH.make_mesh_spec(1, 4, device=device)
    conf = _cfg(g)
    S, B = conf["shape"]
    batch = _batch(g, ARCHS[0], device)
    for case, ov in conf["odd_heads"].items():
        cfg = get_config(ARCHS[0]).reduced().replace(dtype="float32", **ov)
        api = R.get_model(cfg)
        params = unflatten(g, f"odd/{case}/init/")
        pre = f"odd/{case}/mesh/"
        _greedy(cfg, mesh, ShapeSpec("mesh", "prefill", S, B),
                from_jax(params, cfg, device), batch["tokens"],
                conf["new"], out, pre)
        plan = dataclasses.replace(PL.default_plan(
            cfg, ShapeSpec("mesh", "train", S, B), mesh), attn_mode="chunked")
        model = from_jax(params, cfg, device)
        PL.distribute_model(model, plan, mesh)
        model.requires_grad_(True)
        loss, met, grads = value_and_grads(api, plan.runtime(mesh), model,
                                           batch)
        out.update({pre + "loss": _np(loss), pre + "nll": _np(met["nll"]),
                    pre + "aux": _np(met["aux"])})
        out.update(_jax_tree(grads, pre + "grads/"))


def _reshard(cfg, api, opt, directory, dims, device, plan, label,
             shardings: bool) -> dict:
    """Restore the checkpoint onto a ``dims`` mesh under ``plan``'s rules
    -> ``reshard/<label>/<leaf>`` full arrays: into a state whose model is
    already placed there, or (``shardings``) into a one-device state with
    ``restore(..., shardings=)`` placing every leaf."""
    from repro_torch.models.runtime import placements
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_state
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import plans as PL
    mesh = MESH.make_mesh_spec(*dims, device=device)
    model = api.init(torch.Generator(device=device).manual_seed(1))
    where = None
    if shardings:
        named = dict(model.named_parameters())
        specs = {n: PL.sanitize_spec(sp, named[n].shape, mesh)
                 for n, sp in PL.param_pspecs(named, plan).items()}
        state = init_state(api, opt, model=model, device=device)
        opt_specs = PL.opt_pspecs(state.opt, specs, plan)
        where = {f"params/{n}": (mesh, placements(sp, mesh))
                 for n, sp in specs.items()}
        where.update({f"opt/mu/{n}/{t}": (mesh, placements(sp, mesh))
                      for n, st in opt_specs["mu"].items()
                      for t, sp in st.items()})
    else:
        PL.distribute_model(model, plan, mesh)
        state = init_state(api, opt, model=model, device=device)
    state = ckpt.restore(directory, state, shardings=where)
    from repro_torch.train.checkpoint import _leaves
    return {f"reshard/{label}/{k}": (_np(v) if isinstance(v, torch.Tensor)
                                     else np.asarray(v))
            for k, v in _leaves(state).items()}


def run_1x1(g: dict, device: str, ckpt_dir: str) -> dict:
    """The world-1 cases: each mesh route beside the unsharded one, and the
    restore onto 1 x 1."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry as R
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    conf = _cfg(g)
    mesh = MESH.make_mesh_spec(1, 1, device=device)
    S, B = conf["shape"]
    out: dict = {}
    for arch in ARCHS:
        cfg, _ = model_of(g, arch, device)
        api = R.get_model(cfg)
        batch = _batch(g, arch, device)
        shape = ShapeSpec("mesh", "train", S, B)
        built = ST.build_train(cfg, shape, mesh)
        plain_rt = built.plan.runtime(None)
        for route in ("mesh", "plain"):
            _, model = model_of(g, arch, device)
            if route == "mesh":
                built.place_model(model)
                fn = built.fn
            else:
                fn = make_train_step(api, plain_rt, built.opt, device=device)
            state = init_state(api, built.opt, model=model, device=device)
            state, met = fn(state, batch)
            pre = f"one/{arch}/train/{route}/"
            out.update({pre + "loss": _np(met["loss"]),
                        pre + "grad_norm": _np(met["grad_norm"])})
            out.update(_jax_tree(dict(model.named_parameters()),
                                 pre + "params/"))
            pshape = ShapeSpec("mesh", "prefill", S, B)
            _, model = model_of(g, arch, device)
            rt = ST.build_prefill(cfg, pshape, mesh).plan.runtime(None)
            pre = f"one/{arch}/serve/{route}/"
            if route == "mesh":
                _greedy(cfg, mesh, pshape, model, batch["tokens"],
                        conf["new"], out, pre)
            else:
                _plain_greedy(api, cfg, rt, model, batch["tokens"],
                              conf["new"], out, pre)
        if arch == ARCHS[0]:
            out.update(_reshard(cfg, api, built.opt,
                                os.path.join(ckpt_dir, "2x2"), (1, 1),
                                device, built.plan, "1x1", shardings=False))
    return out


def _plain_greedy(api, cfg, rt, model, tokens, new, out, pre):
    rt = dataclasses.replace(rt, attn_mode="chunked")
    logits, cache = api.prefill(model, {"tokens": tokens}, rt,
                                max_len=tokens.shape[1] + new)
    out[pre + "prefill/logits"] = _np(logits)[:, -1]
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    toks = []
    for i in range(new):
        toks.append(tok.cpu().numpy())
        logits, cache = api.decode_step(model, cache, tok[:, None].int(), rt)
        if i == 0:
            out[pre + "decode/logits0"] = _np(logits)[:, -1]
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    out[pre + "decode/tokens"] = np.stack(toks, 1).astype(np.int32)


def _bad_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))


def rank_main(rank: int, world: int, init: str, out_path: str,
              ckpt_dir: str, device: str) -> None:
    """One rank: join, run the world's cases, rank 0 writes them."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as MESH
    torch.set_num_threads(1)
    if device == "cuda":                     # the ranks share the card
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    MESH.init_process_group("gloo", rank=rank, world_size=world,
                            init_method=init)
    try:
        g = golden()
        out = (run_2x2(g, device, ckpt_dir) if world == 4
               else run_1x1(g, device, ckpt_dir))
        bad = [None] * world
        dist.all_gather_object(bad, _bad_modules())
        out["modules/bad"] = np.array(json.dumps(sorted(
            {m for b in bad for m in b})))
        if rank == 0:
            np.savez(out_path, **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world: int, out_path: str, ckpt_dir: str,
          device: str = "cpu") -> None:
    """Run the ``world`` cases (4 or 1) in ``world`` spawned ranks (gloo, a
    file rendezvous) on ``device``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(world, "file://" + os.path.join(d, "rdv"),
                                  out_path, ckpt_dir, device),
                 nprocs=world)
