"""Carry the JAX package's LM parameters across to the port.

The JAX package keeps a dense transformer's params as nested dicts of
arrays, every per-layer leaf stacked on a leading ``n_layers`` axis
(``models/transformer.py::init``).  :func:`from_jax` takes that tree with
numpy arrays (or anything ``np.asarray`` takes) as leaves and builds the
port's :class:`~repro_torch.models.transformer.TransformerLM` from it on a
given device (``cuda`` unless the caller asks for another), so that both
packages compute with the same weights.
:func:`flatten` and :func:`unflatten` map the tree to and from flat
``"a/b/c"`` keys, as an ``.npz`` file holds it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .layers import Params
from .runtime import resolve_device
from .transformer import Block, TransformerLM, _dense_only

#: the params of one decoder block, by submodule
BLOCK_KEYS = ("ln1", "attn", "ln2", "mlp")


def to_tensor(a, device="cuda") -> torch.Tensor:
    """A numpy array (bfloat16 ones included) as a torch tensor on
    ``device``."""
    device = resolve_device(device, "to_tensor")
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":           # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _bag(tree: Mapping, device, layer: int | None = None) -> Params:
    return Params(**{k: to_tensor(v if layer is None else np.asarray(v)[layer],
                                  device) for k, v in tree.items()})


def from_jax(params: Mapping, cfg, device="cuda") -> TransformerLM:
    """The port's model holding the JAX package's ``params`` for ``cfg``,
    on ``device``."""
    _dense_only(cfg)
    device = resolve_device(device, "from_jax")
    stacked = params["layers"]
    if sorted(stacked) != sorted(BLOCK_KEYS):
        raise ValueError(f"layers hold {sorted(stacked)}, expected "
                         f"{sorted(BLOCK_KEYS)}")
    for name, sub in stacked.items():
        for k, v in sub.items():
            if np.shape(v)[0] != cfg.n_layers:
                raise ValueError(f"layers/{name}/{k} has {np.shape(v)[0]} "
                                 f"layers, {cfg.name} has {cfg.n_layers}")
    mods = {"embed": _bag(params["embed"], device),
            "layers": nn.ModuleList(
                Block({name: _bag(stacked[name], device, i)
                       for name in BLOCK_KEYS})
                for i in range(cfg.n_layers)),
            "final_norm": _bag(params["final_norm"], device)}
    if "head" in params:
        mods["head"] = _bag(params["head"], device)
    return TransformerLM(mods)


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat: Mapping, prefix: str = "") -> dict:
    """{"<prefix>a/b/c": array} -> nested dicts, for the keys under
    ``prefix``."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return out
