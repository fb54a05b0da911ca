"""Optimizers: AdamW and factored-second-moment (Adafactor-style) AdamW.

The PyTorch port of the JAX package's ``train/optimizer.py``, with its
design points:

* ``state_dtype``: bf16 first/second moments halve optimizer memory (the
  update runs in f32 before casting back);
* ``factored=True``: the second moment of every big enough matrix is
  stored as a row+column factor pair (Adafactor), O(d1+d2) instead of
  O(d1*d2);
* ``momentum=False`` drops the first moment (Adafactor's b1 = 0).

Parameters, gradients and state are dicts keyed by the port's parameter
names (``model.named_parameters()``).  The JAX package decides two things
on a leaf's shape in its layer-stacked layout, where a per-layer norm
scale is (n_layers, d): which leaves are factored and which take weight
decay (every leaf of two or more dims, those stacked norm scales and
biases included).  The port decides them on the same shapes
(``models/convert.py::stacked_shapes``), so that one update equals the
JAX package's.  The schedules take the step as a tensor and compute on
its device: an update reads nothing back to the host.

On a mesh the parameters and gradients are DTensors: each moment takes
its parameter's placements (the factored ``v_row`` drops the last dim's
sharding, ``v_col`` the second to last's, ``launch/plans.py::opt_pspecs``),
the gradient norm is the sum of every shard's squares (a partial sum
reduced across the ranks), and every new value is written back on its
leaf's own placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from ..models.convert import stacked_shapes


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------
def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)
                ).clamp(0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant_lr(v: float) -> Callable:
    return lambda step: torch.full((), v, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


# --------------------------------------------------------------------------
# gradient utilities
# --------------------------------------------------------------------------
def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32, the leaves
    added in order."""
    total = None
    for g in tree.values():
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return total.sqrt()


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, \
        norm


# --------------------------------------------------------------------------
# AdamW (+ factored option)
# --------------------------------------------------------------------------
def _zeros(p, shape, dtype, drop: int | None = None):
    """Zeros of ``shape`` on ``p``'s device; a DTensor on ``p``'s mesh
    where ``p`` is one, with ``p``'s placements less the sharding of its
    dim ``drop`` (the dims after it move down one)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    pl = []
    for q in p.placements:
        if isinstance(q, Shard) and drop is not None:
            d = q.dim % p.ndim
            q = Replicate() if d == drop else (Shard(d - 1) if d > drop
                                               else q)
        pl.append(q)
    from torch.distributed.tensor import distribute_tensor
    z = torch.zeros(shape, dtype=dtype, device=p.to_local().device)
    return distribute_tensor(z, p.device_mesh, pl, src_data_rank=None)


def _write(dst, src):
    """``dst.copy_(src)``, ``src`` first moved to ``dst``'s placements
    where both are DTensors."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor) and isinstance(src, DTensor) \
            and src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def _should_factor(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def _layouts(params: Mapping[str, torch.Tensor]) -> dict[str, tuple]:
    """Each parameter's shape in the JAX package's stacked layout."""
    return stacked_shapes({k: tuple(p.shape) for k, p in params.items()})


@dataclass(frozen=True)
class AdamW:
    lr: Callable = constant_lr(1e-4)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    factored: bool = False            # Adafactor-style v for big matrices
    momentum: bool = True             # False (Adafactor b1=0) drops m
    max_grad_norm: float = 1.0

    # ---- state ----
    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        """{"mu": {name: {"m"?, "v" | "v_row", "v_col"}}, "count"}: zeros
        on each parameter's device, m and v in ``state_dtype``, the factors
        in f32, ``count`` an int32 scalar."""
        sd = getattr(torch, self.state_dtype)
        shapes = _layouts(params)
        mu = {}
        for name, p in params.items():
            st = {"m": _zeros(p, p.shape, sd)} if self.momentum else {}
            if self.factored and _should_factor(shapes[name]):
                if p.ndim < 2:
                    raise NotImplementedError(
                        f"{name}: the JAX layout factors a {shapes[name]} "
                        f"stack across its layers")
                st["v_row"] = _zeros(p, p.shape[:-1], torch.float32,
                                     drop=p.ndim - 1)
                st["v_col"] = _zeros(p, p.shape[:-2] + p.shape[-1:],
                                     torch.float32, drop=p.ndim - 2)
            else:
                st["v"] = _zeros(p, p.shape, sd)
            mu[name] = st
        dev = next(iter(params.values())).device
        return {"mu": mu,
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    # ---- update ----
    def _leaf(self, p, g, st, ndim_stacked, b1, c1, c2, lr):
        """One leaf's (new param, new state), in f32 arithmetic."""
        g = g.float()
        m = st["m"].float() * b1 + g * (1 - b1) if self.momentum else g
        if "v" in st:
            v = st["v"].float() * self.b2 + g * g * (1 - self.b2)
            vhat = v / c2
            new_v = {"v": v.to(st["v"].dtype)}
        else:
            g2 = g * g + 1e-30
            v_row = st["v_row"] * self.b2 + g2.mean(-1) * (1 - self.b2)
            v_col = st["v_col"] * self.b2 + g2.mean(-2) * (1 - self.b2)
            # rank-1 reconstruction (Adafactor): R*C / mean(R)
            denom = v_row.mean(-1, keepdim=True) + 1e-30
            vhat = (v_row[..., None] * v_col[..., None, :]
                    / denom[..., None]) / c2
            new_v = {"v_row": v_row, "v_col": v_col}
        upd = (m / c1) / (torch.sqrt(vhat) + self.eps)
        if self.weight_decay and ndim_stacked >= 2:
            upd = upd + self.weight_decay * p.float()
        new_p = (p.float() - lr * upd).to(p.dtype)
        return new_p, ({"m": m.to(st["m"].dtype), **new_v}
                       if self.momentum else new_v)

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: dict,
                params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The JAX package's ``update`` written into ``params`` and
        ``state`` in place, leaf by leaf (the model's memory holds one
        leaf's new values at a time, not a second copy of every parameter
        and moment); returns the gradients' global norm before the clip."""
        count = state["count"] + 1
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        b1 = self.b1 if self.momentum else 0.0
        cf = count.float()
        c1 = 1.0 - torch.pow(b1, cf)
        c2 = 1.0 - torch.pow(self.b2, cf)
        lr = self.lr(count)
        shapes = _layouts(params)
        for name, p in params.items():
            new_p, st = self._leaf(p, grads[name], state["mu"][name],
                                   len(shapes[name]), b1, c1, c2, lr)
            _write(p, new_p)
            for k, t in st.items():
                _write(state["mu"][name][k], t)
        state["count"] = count
        return gnorm


def make_optimizer(name: str = "adamw", *, peak_lr: float = 3e-4,
                   warmup: int = 100, total_steps: int = 10_000,
                   weight_decay: float = 0.1, state_dtype: str = "float32",
                   factored: bool = False, momentum: bool = True,
                   max_grad_norm: float = 1.0) -> AdamW:
    if name not in ("adamw", "adafactor"):
        raise KeyError(f"unknown optimizer {name!r}")
    return AdamW(
        lr=warmup_cosine(peak_lr, warmup, total_steps),
        weight_decay=weight_decay,
        state_dtype=state_dtype,
        factored=factored or name == "adafactor",
        momentum=momentum,
        max_grad_norm=max_grad_norm,
    )
