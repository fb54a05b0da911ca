"""The port's LM mesh on the cases of ``golden_mesh_families.npz``.

A rank program, as ``torch_mesh_check``: each of four ranks joins a gloo
process group, builds the reduced f32 Mamba2, Zamba2, Whisper and
InternVL2 with the params ``golden_lm_families.npz`` holds, and runs them
on each mesh of the golden file (2 x 2 and 1 x 4 (data, model) over the
same world); rank 0 writes what they return, under ``<mesh>/<arch>/``:

* ``train/{loss,nll,aux}`` and ``train/grads/<path>``: ``default_plan``'s
  loss and gradients (ZeRO-3 over data, tp over model; the arch's
  attention path), the gradients in the JAX layout;
* ``prefill/logits``, ``decode/tokens``, ``decode/logits0``: prefill
  through ``launch.steps.build_prefill`` (its cache on ``cache_pspecs``'
  placements) with a cache of ``new`` more positions, then ``new`` greedy
  decode steps through ``build_decode``, on the golden file's serving
  plans (under ``long/`` the cache's sequence sharded, as a long_500k
  cell's);
* ``cache_placements``: each cache leaf's placements, JSON.

and ``modules/bad``, any ``jax`` or ``repro`` module in a rank's
``sys.modules``.  Nothing here compares (``tests/test_torch_mesh_families.py``
on the CPU, ``chip_smoke.py`` phase 20 (b) on the card, the ranks sharing
it); it imports the port alone, never ``jax`` or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "data")
GOLDEN_MESH_FAMILIES = os.path.join(DATA, "golden_mesh_families.npz")


def golden() -> dict:
    with np.load(GOLDEN_MESH_FAMILIES) as z:
        return {k: z[k] for k in z.files}


def conf(g: dict) -> dict:
    return json.loads(str(g["config"]))


def case(g: dict, arch: str):
    """(config, train ShapeSpec, train attention path) of ``arch``: the
    reduced f32 config of ``golden_train.npz``'s case, at the golden
    file's shape."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    c = conf(g)
    with np.load(os.path.join(DATA, "golden_train.npz")) as z:
        overrides = json.loads(str(z[f"{arch}/overrides"]))
        attn = json.loads(str(z[f"{arch}/runtime"]))["attn_mode"]
    cfg = get_config(arch).reduced().replace(dtype="float32", **overrides)
    S, B = c["shape"].get(arch, c["shape_default"])
    return cfg, ShapeSpec("mesh", "train", S, B), attn


def model_of(cfg, arch: str, device):
    from repro_torch.models.convert import from_jax, unflatten
    with np.load(os.path.join(DATA, "golden_lm_families.npz")) as z:
        params = unflatten({k: z[k] for k in z.files}, f"{arch}/params/")
    return from_jax(params, cfg, device)


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _batch(g: dict, arch: str, device) -> dict:
    pre = f"{arch}/batch/"
    return {k[len(pre):]: torch.from_numpy(v).to(device)
            for k, v in g.items() if k.startswith(pre)}


def _placements(cache) -> dict:
    from torch.distributed.tensor import DTensor
    if isinstance(cache, dict):
        return {k: _placements(v) for k, v in cache.items()
                if isinstance(v, (dict, DTensor))}
    return str(tuple(cache.placements))


def run(g: dict, device: str) -> dict:
    """Every arch on every mesh of the golden file (module docstring)."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import plans as PL
    from repro_torch.models import registry as R
    from repro_torch.models.convert import flatten, to_jax
    from repro_torch.train.train_step import value_and_grads
    c = conf(g)
    new = c["new"]
    out: dict = {}
    for mname, dims in c["meshes"].items():
        mesh = MESH.make_mesh_spec(*dims, device=device)
        for arch in c["archs"]:
            pre = f"{mname}/{arch}/"
            cfg, shape, attn = case(g, arch)
            api = R.get_model(cfg)
            batch = _batch(g, arch, device)
            plan = dataclasses.replace(PL.default_plan(cfg, shape, mesh),
                                       attn_mode=attn)
            model = model_of(cfg, arch, device)
            PL.distribute_model(model, plan, mesh)
            model.requires_grad_(True)
            loss, met, grads = value_and_grads(api, plan.runtime(mesh),
                                               model, batch)
            out.update({pre + "train/loss": _np(loss),
                        pre + "train/nll": _np(met["nll"]),
                        pre + "train/aux": _np(met["aux"])})
            out.update(flatten(to_jax({k: torch.from_numpy(_np(v))
                                       for k, v in grads.items()}),
                               pre + "train/grads/"))
            inputs = {k: v for k, v in batch.items() if k != "labels"}
            for key, ov, where in c["serve"]:
                if where is None or arch in where.get(mname, ()):
                    _serve(cfg, arch, mesh, inputs, shape, new, ov, device,
                           out, pre + key)
    return out


def _serve(cfg, arch, mesh, inputs, shape, new: int, ov: dict, device,
           out: dict, pre: str) -> None:
    """Prefill through ``build_prefill`` (its cache on ``cache_pspecs``'
    placements) with a cache of ``new`` more positions, then ``new``
    greedy decode steps through ``build_decode``, on the serving plan
    (the chunked attention, ``ov``'s overrides)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import plans as PL
    from repro_torch.launch import steps as ST
    S = inputs["tokens"].shape[1]
    pshape = ShapeSpec("mesh", "prefill", shape.seq_len, shape.global_batch)
    splan = dataclasses.replace(
        PL.default_plan(cfg, pshape, mesh), attn_mode="chunked",
        **{k: tuple(v) if isinstance(v, list) else v for k, v in ov.items()})
    prefill = ST.build_prefill(cfg, pshape, mesh, splan)
    decode = ST.build_decode(cfg, dataclasses.replace(
        pshape, kind="decode", seq_len=S + new), mesh, splan)
    model = prefill.place_model(model_of(cfg, arch, device))
    logits, cache = prefill.fn(model, inputs, max_len=S + new)
    out[pre + "prefill/logits"] = _np(logits)[:, -1]
    out[pre + "cache_placements"] = np.array(json.dumps(_placements(cache)))
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


def rank_main(rank: int, world: int, init: str, out_path: str,
              device: str) -> None:
    """One rank: join, run the cases, rank 0 writes them."""
    import sys

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
        out = run(golden(), device)
        bad = [None] * world
        dist.all_gather_object(bad, sorted(
            m for m in sys.modules if m in ("jax", "repro")
            or m.startswith(("jax.", "repro."))))
        out["modules/bad"] = np.array(json.dumps(sorted(
            {m for b in bad for m in b})))
        if rank == 0:
            np.savez(out_path, **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(out_path: str, device: str = "cpu") -> None:
    """Run the cases in four spawned ranks (gloo, a file rendezvous) on
    ``device``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(4, "file://" + os.path.join(d, "rdv"),
                                  out_path, device), nprocs=4)
