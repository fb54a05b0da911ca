"""Fault-tolerant checkpointing of a training state.

The PyTorch port of the JAX package's ``train/checkpoint.py``, with its
layout (one directory per step)::

    <dir>/step_00000100/
        manifest.json      # the state's structure, shapes, dtypes, extra
        arrays.npz         # flat {path -> ndarray}
        COMMIT             # written last: a checkpoint without it is partial

A checkpoint is written into a ``.tmp_ckpt_*`` directory and renamed into
place once its ``COMMIT`` is written, then the oldest are pruned to
``keep``.  ``restore(dir, target)`` reads the latest *committed* step
(partial writes of a killed process are skipped) into ``target``'s
tensors, on their device.  bf16 tensors are stored as their raw uint16
bits (npz has no bfloat16), so a restore is bit-exact.

A :class:`~repro_torch.train.train_step.TrainState` flattens to
``params/<name>`` (its model's parameters by name), ``opt/mu/<name>/<m |
v | v_row | v_col>``, ``opt/count`` and ``step``; a dict of tensors to its
keys joined by ``/``.

On a mesh (parameters and moments that are DTensors) every rank calls
:func:`save`: each DTensor is gathered to its full value, rank 0 writes
the same layout as on one device and the others wait at a barrier.
:func:`restore` gives each DTensor leaf of the target its own shard of the
saved full array, on the target's mesh and placements, whatever mesh saved
it: the elastic reshard.  ``restore(..., shardings=...)`` places plain
leaves onto a mesh (the JAX package's ``device_put`` with a sharding).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

_SEP = "/"


def _leaves(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{path: leaf} of a TrainState, a dict or a tensor/int."""
    from .train_step import TrainState
    if isinstance(tree, TrainState):
        return {**_leaves(dict(tree.model.named_parameters()),
                          prefix + "params" + _SEP),
                **_leaves(tree.opt, prefix + "opt" + _SEP),
                prefix + "step": tree.step}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix.rstrip(_SEP): tree}


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _to_array(leaf) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz cannot hold bfloat16; store the raw bits
            return t.view(torch.uint16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(state) -> dict[str, np.ndarray]:
    return {k: _to_array(v) for k, v in _leaves(state).items()}


def save(directory: str, step: int, state, *, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write a committed checkpoint; prune old ones.  In a
    process group of more than one rank every rank calls it: the DTensors
    are gathered, rank 0 writes, and all return after the commit."""
    final = os.path.join(directory, f"step_{step:08d}")
    if _distributed():
        import torch.distributed as dist
        flat = _flatten(state)                  # every rank gathers
        if dist.get_rank() == 0:
            _write(directory, final, step, state, flat, extra, keep)
        dist.barrier()
        return final
    return _write(directory, final, step, state, _flatten(state), extra,
                  keep)


def _write(directory, final, step, state, flat, extra, keep) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "treedef": type(state).__name__,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: _dtype_name(v) for k, v in _leaves(state).items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(directory, keep)
    return final


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _prune(directory: str, keep: int):
    steps = committed_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "COMMIT")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, target, *, step: int | None = None,
            shardings: dict | None = None):
    """Read a committed checkpoint (the latest unless ``step``) into
    ``target`` (a TrainState or a dict of tensors of the saved
    structure): every tensor is written in place, on its own device, bit
    for bit, a DTensor's shard on its own placements; a missing leaf or a
    shape that differs raises.  ``shardings``, {leaf path: (mesh,
    placements)}, first replaces those leaves of the target by DTensors so
    placed (a TrainState's parameters in its model).  Returns the target,
    with a TrainState's ``step`` set."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from .train_step import TrainState
    if shardings:
        target = _place(target, shardings)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with torch.no_grad():
        for key, leaf in _leaves(target).items():
            if key not in flat:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            arr = flat[key]
            if not isinstance(leaf, torch.Tensor):
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"target {tuple(leaf.shape)}")
            src = torch.from_numpy(np.array(arr))      # 0-d stays 0-d
            if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
                src = src.view(torch.bfloat16)      # bit-exact restore
            src = src.to(leaf.dtype)
            if isinstance(leaf, DTensor):
                local = leaf.to_local()
                shard = distribute_tensor(src.to(local.device),
                                          leaf.device_mesh, leaf.placements,
                                          src_data_rank=None)
                local.copy_(shard.to_local())
            else:
                leaf.copy_(src)
    if isinstance(target, TrainState):
        target.step = int(flat["step"])
    return target


def _place(target, shardings: dict):
    """``target`` with the leaves ``shardings`` names replaced by zero
    DTensors on their (mesh, placements); a TrainState's parameters are
    replaced in its model, as ``nn.Parameter``s."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    from .train_step import TrainState

    def dt(leaf, where):
        mesh, pl = where
        z = torch.zeros(leaf.shape, dtype=leaf.dtype,
                        device=mesh.device_type)
        return distribute_tensor(z, mesh, pl, src_data_rank=None)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}{_SEP}") for k, v in tree.items()}
        key = prefix.rstrip(_SEP)
        return dt(tree, shardings[key]) if key in shardings else tree
    if isinstance(target, TrainState):
        for mname, mod in target.model.named_modules():
            for pname, p in list(mod._parameters.items()):
                key = "params" + _SEP + (f"{mname}.{pname}" if mname
                                         else pname)
                if key in shardings:
                    mod._parameters[pname] = nn.Parameter(
                        dt(p, shardings[key]), requires_grad=p.requires_grad)
        target.opt = walk(target.opt, "opt" + _SEP)
        return target
    return walk(target, "")


def manifest(directory: str, step: int | None = None) -> dict:
    if step is None:
        step = latest_step(directory)
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)
