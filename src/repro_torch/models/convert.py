"""Carry the JAX package's LM parameters across to the port.

The JAX package keeps a model's params as nested dicts of arrays, every
per-layer leaf stacked on a leading layer axis (``n_layers`` for the
transformer's ``layers``; ``n_enc_layers``/``n_dec_layers`` for the
enc-dec stacks; ``tail`` for the SSM LM's ungrouped blocks; and
``(g, attn_every)``, doubly, for the hybrid's ``groups``).
:func:`from_jax` takes that tree with numpy arrays (or anything
``np.asarray`` takes) as leaves, checks every leaf against the shapes the
config needs (:func:`param_shapes`: a missing, extra or misshapen leaf,
a short layer stack among them, raises), and builds the port's model of
the config's family from it on a given device (``cuda`` unless the caller
asks for another), so that both packages compute with the same weights.
:func:`flatten` and :func:`unflatten` map the tree to and from flat
``"a/b/c"`` keys, as an ``.npz`` file holds it.

The other direction, for training: a port parameter's name
(``layers.3.attn.wq``, ``groups.1.0.mixer.in_proj``) is its JAX path with
the indices of its stacked axes among the components (:func:`jax_path`).
:func:`to_jax` stacks named tensors (the parameters, or their gradients)
back into the JAX layout as numpy arrays, :func:`stacked_shapes` gives
each name its leaf's shape there, and :func:`opt_state_from_jax` takes
the JAX package's AdamW state apart into the port's, name by name.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .encdec import EncDecLM
from .layers import Params
from .runtime import resolve_device
from .ssm_lm import SSMLM, _group_split
from .transformer import Block, TransformerLM


def to_tensor(a, device="cuda") -> torch.Tensor:
    """A numpy array (bfloat16 ones included) as a torch tensor on
    ``device``."""
    device = resolve_device(device, "to_tensor")
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":           # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


# --------------------------------------------------------------------------
# the shapes a config's params take, as the JAX package's init makes them
# --------------------------------------------------------------------------
def _stacked(tree: dict, lead: tuple) -> dict:
    return {k: _stacked(v, lead) if isinstance(v, dict) else lead + v
            for k, v in tree.items()}


def param_shapes(cfg) -> dict:
    """The nested dict of leaf shapes of ``cfg``'s params in the JAX
    package's layout."""
    d, hd, F = cfg.d_model, cfg.head_dim, cfg.frontend_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def norm(n=d):
        return {"scale": (n,)}

    def attn():
        p = {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "wo": (nq, d)}
        if cfg.qkv_bias:
            p.update(bq=(nq,), bk=(nkv,), bv=(nkv,))
        return p

    def mlp():
        f = cfg.d_ff
        if cfg.mlp_act == "swiglu":
            return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
        return {"wu": (d, f), "bu": (f,), "wd": (f, d), "bd": (d,)}

    def moe():
        e, f = cfg.n_experts, cfg.moe_d_ff
        p = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f),
             "wd": (e, f, d)}
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            p["shared"] = {"wg": (d, fs), "wu": (d, fs), "wd": (fs, d)}
        return p

    def mamba_block():
        di, H = cfg.d_inner, cfg.n_ssm_heads
        gn = cfg.n_ssm_groups * cfg.ssm_state
        return {"ln": norm(), "mixer": {
            "in_proj": (d, 2 * di + 2 * gn + H),
            "conv_w": (cfg.ssm_conv, di + 2 * gn), "conv_b": (di + 2 * gn,),
            "A_log": (H,), "dt_bias": (H,), "D": (H,), "norm": norm(di),
            "out_proj": (di, d)}}

    embed = {"table": (cfg.padded_vocab, d)}
    if cfg.pos_emb == "abs":
        embed["pos"] = (cfg.max_abs_positions, d)
    tree = {"embed": embed, "final_norm": norm()}
    if not cfg.tie_embeddings:
        tree["head"] = {"w": (d, cfg.padded_vocab)}
    if cfg.family in ("ssm", "hybrid"):
        g, tail = _group_split(cfg)
        if g:
            tree["groups"] = _stacked(mamba_block(), (g, cfg.attn_every))
            tree["shared"] = {"ln1": norm(), "attn": attn(), "ln2": norm(),
                              "mlp": mlp()}
        if tail:
            tree["tail"] = _stacked(mamba_block(), (tail,))
    elif cfg.family == "encdec":
        enc = {"ln1": norm(), "attn": attn(), "ln2": norm(), "mlp": mlp()}
        dec = {"ln1": norm(), "attn": attn(), "lnx": norm(), "xattn": attn(),
               "ln2": norm(), "mlp": mlp()}
        tree.update(adapter={"w": (F, d)}, enc_pos=(cfg.max_abs_positions, d),
                    enc_layers=_stacked(enc, (cfg.n_enc_layers,)),
                    enc_norm=norm(),
                    dec_layers=_stacked(dec, (cfg.n_dec_layers,)))
    else:
        block = {"ln1": norm(), "attn": attn(), "ln2": norm()}
        block.update({"moe": moe()} if cfg.n_experts else {"mlp": mlp()})
        tree["layers"] = _stacked(block, (cfg.n_layers,))
        if cfg.family == "vlm":
            tree["projector"] = {"w": (F, d), "b": (d,)}
    return tree


def _check(params: Mapping, cfg) -> None:
    want = {k: tuple(v) for k, v in flatten(param_shapes(cfg)).items()}
    got = {k: np.shape(v) for k, v in flatten(params).items()}
    missing, extra = sorted(want.keys() - got), sorted(got.keys() - want)
    if missing or extra:
        raise ValueError(f"{cfg.name}: the params lack {missing} and hold "
                         f"{extra} beyond the config's")
    for k, shape in want.items():
        if got[k] != shape:
            raise ValueError(f"{k} has shape {got[k]}, {cfg.name} needs "
                             f"{shape}")


# --------------------------------------------------------------------------
# the port's model from the checked tree
# --------------------------------------------------------------------------
def _bag(tree: Mapping, device, index: tuple = ()) -> Params:
    """A (nested) dict -> a (nested) :class:`Params`, each leaf taken at
    ``index`` of its leading axes."""
    return Params(**{k: _bag(v, device, index) if isinstance(v, Mapping)
                     else to_tensor(np.asarray(v)[index], device)
                     for k, v in tree.items()})


def _blocks(stacked: Mapping, n: int, device, cls=nn.ModuleDict,
            index: tuple = ()) -> nn.ModuleList:
    """The n blocks of a stacked tree, block i at ``index + (i,)``."""
    return nn.ModuleList(
        cls({name: _bag(sub, device, index + (i,))
             for name, sub in stacked.items()}) for i in range(n))


def from_jax(params: Mapping, cfg, device="cuda") -> nn.Module:
    """The port's model holding the JAX package's ``params`` for ``cfg``,
    on ``device``."""
    device = resolve_device(device, "from_jax")
    _check(params, cfg)
    mods = {name: _bag(params[name], device)
            for name in ("embed", "final_norm", "head") if name in params}
    if cfg.family in ("ssm", "hybrid"):
        g, tail = _group_split(cfg)
        if g:
            mods["groups"] = nn.ModuleList(
                _blocks(params["groups"], cfg.attn_every, device,
                        index=(gi,)) for gi in range(g))
            mods["shared"] = nn.ModuleDict(
                {k: _bag(v, device) for k, v in params["shared"].items()})
        if tail:
            mods["tail"] = _blocks(params["tail"], tail, device)
        return SSMLM(mods)
    if cfg.family == "encdec":
        return EncDecLM(
            **mods, adapter=_bag(params["adapter"], device),
            enc_pos=to_tensor(params["enc_pos"], device),
            enc_layers=_blocks(params["enc_layers"], cfg.n_enc_layers,
                               device),
            enc_norm=_bag(params["enc_norm"], device),
            dec_layers=_blocks(params["dec_layers"], cfg.n_dec_layers,
                               device))
    mods["layers"] = _blocks(params["layers"], cfg.n_layers, device, Block)
    if "projector" in params:
        mods["projector"] = _bag(params["projector"], device)
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


# --------------------------------------------------------------------------
# the port's names in the JAX layout
# --------------------------------------------------------------------------
def jax_path(name: str) -> tuple[str, tuple[int, ...]]:
    """A port parameter's name -> (its leaf's path in the JAX layout, its
    index on the leaf's stacked axes): ``"layers.3.attn.wq"`` ->
    ``("layers/attn/wq", (3,))``, ``"groups.1.0.ln.scale"`` ->
    ``("groups/ln/scale", (1, 0))``, ``"embed.table"`` ->
    ``("embed/table", ())``."""
    parts = name.split(".")
    return ("/".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def _stacks(names) -> dict[str, tuple[int, ...]]:
    """Each JAX path's stacked axes' lengths, from the names on it."""
    lead: dict[str, tuple[int, ...]] = {}
    for name in names:
        path, idx = jax_path(name)
        old = lead.get(path, (0,) * len(idx))
        lead[path] = tuple(max(a, i + 1) for a, i in zip(old, idx))
    return lead


def stacked_shapes(shapes: Mapping[str, tuple]) -> dict[str, tuple]:
    """{name: shape} of the port's tensors -> {name: the shape of the JAX
    layout's leaf it is a slice of} (the stacked axes ahead)."""
    lead = _stacks(shapes)
    return {n: lead[jax_path(n)[0]] + tuple(s) for n, s in shapes.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 widened to f32 (exact:
    numpy has no bfloat16 of its own)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def to_jax(named: Mapping[str, torch.Tensor]) -> dict:
    """Named tensors (``model.named_parameters()``, or gradients keyed so)
    -> the JAX layout's nested dict of numpy arrays, the per-layer ones
    stacked on their leading axes: the inverse of :func:`from_jax`'s
    unstacking."""
    named = dict(named)
    lead = _stacks(named)
    flat: dict[str, np.ndarray] = {}
    for name, t in named.items():
        path, idx = jax_path(name)
        a = to_numpy(t)
        if not idx:
            flat[path] = a
            continue
        if path not in flat:
            flat[path] = np.zeros(lead[path] + a.shape, a.dtype)
        flat[path][idx] = a
    return unflatten(flat)


def opt_state_from_jax(state: Mapping, names, device="cuda") -> dict:
    """The JAX package's AdamW state ``{"mu": tree of {"m", "v" | "v_row",
    "v_col"}, "count"}`` -> the port's (``train.optimizer.AdamW.init``'s
    layout: ``{"mu": {name: {...}}, "count"}``) for the parameters
    ``names``, each leaf the slice of its stacked one, on ``device``."""
    device = resolve_device(device, "opt_state_from_jax")
    flat = flatten(state["mu"])
    mu = {}
    for name in names:
        path, idx = jax_path(name)
        mu[name] = {k[len(path) + 1:]: to_tensor(np.asarray(v)[idx], device)
                    for k, v in flat.items()
                    if k.startswith(path + "/")
                    and "/" not in k[len(path) + 1:]}
    return {"mu": mu, "count": to_tensor(np.asarray(state["count"]),
                                         device)}
