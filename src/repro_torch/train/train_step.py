"""Train step factory: the loss's gradients and the optimizer, on one
device.

The PyTorch port of the JAX package's ``train/train_step.py``, its
one-device half: :func:`make_train_step` with microbatch accumulation
inside the step, and the per-tensor int8 quantisation.  The gradient is
autograd's (``torch.autograd.grad`` of ``api.loss``) where the JAX package
takes ``jax.value_and_grad``; the update is the optimizer's, written into
the model's parameters and the state's moments in place (the JAX package
donates the old state's buffers to its jitted step to the same end).  The
compressed data-parallel step (``make_compressed_train_step``,
``compressed_psum``, ``init_residuals``) needs the mesh and waits for it
(``ROADMAP.md`` queue 1, item 11).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..data.pipeline import to_device
from ..models.runtime import resolve_device
from .optimizer import AdamW


@dataclass
class TrainState:
    """The model (its parameters), the optimizer state and the step."""
    model: nn.Module
    opt: dict
    step: int = 0


def init_state(api, opt: AdamW, gen: torch.Generator | None = None, *,
               model: nn.Module | None = None,
               device="cuda") -> TrainState:
    """A trainable model, its optimizer state and step 0, on ``device``
    (``cuda`` unless the caller asks for another; without a card that
    raises).  The model is ``model`` when given (it must already be on
    ``device``), else ``api.init`` on a generator on ``device`` (``gen``,
    or one seeded 0)."""
    device = resolve_device(device, "init_state")
    if model is None:
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        model = api.init(gen)
    _check_device(model, device)
    model.requires_grad_(True)
    return TrainState(model=model,
                      opt=opt.init(dict(model.named_parameters())), step=0)


def _check_device(model: nn.Module, device: torch.device) -> None:
    for name, p in model.named_parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device != device):
            raise ValueError(f"parameter {name} is on {p.device}, the step "
                             f"runs on {device}")


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """``accum`` microbatches of B / accum rows each, in order."""
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} "
                         f"microbatches")
    n = B // accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(accum)]


def make_train_step(api, rt, opt: AdamW, *, accum: int = 1,
                    device="cuda"):
    """Returns step(state, batch) -> (state, metrics) on ``device``
    (``cuda`` unless the caller asks for another; without a card that
    raises here).  A step takes the gradient of ``api.loss`` over the batch
    or, with ``accum`` > 1, over each of ``accum`` microbatches in turn,
    their f32 sum divided by ``accum`` (the loss and metrics averaged), then
    the optimizer's update, in place.  ``metrics`` holds the loss's
    metrics, ``loss`` and ``grad_norm`` (before the clip), as device
    tensors.  A model on another device raises; nothing falls back."""
    device = resolve_device(device, "make_train_step")

    def grads_of(model, names, params, mb):
        loss, metrics = api.loss(model, mb, rt)
        gs = torch.autograd.grad(loss, params, allow_unused=True,
                                 materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, gs))

    def step(state: TrainState, batch: dict):
        _check_device(state.model, device)
        batch = to_device(batch, device)
        names, params = zip(*state.model.named_parameters())
        if accum == 1:
            loss, metrics, grads = grads_of(state.model, names, params, batch)
        else:
            grads, loss, mets = None, 0.0, []
            for mb in _split_microbatches(batch, accum):
                l, m, g = grads_of(state.model, names, params, mb)
                if grads is None:
                    grads = {k: v.float() for k, v in g.items()}
                else:
                    for k, v in g.items():
                        grads[k] += v
                loss = loss + l
                mets.append(m)
                del g
            grads = {k: v / accum for k, v in grads.items()}
            loss = loss / accum
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        gnorm = opt.update_(grads, state.opt, dict(zip(names, params)))
        state.step += 1
        return state, {**metrics, "loss": loss, "grad_norm": gnorm}

    return step


# --------------------------------------------------------------------------
# gradient compression's quantiser (the all-reduce waits for the mesh)
# --------------------------------------------------------------------------
def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantisation. Returns (q, scale)."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale
