"""Train step factory: the loss's gradients and the optimizer.

The PyTorch port of the JAX package's ``train/train_step.py``.  Two step
flavours:

* :func:`make_train_step`, with microbatch accumulation inside the step.
  The gradient is autograd's (``torch.autograd.grad`` of ``api.loss``)
  where the JAX package takes ``jax.value_and_grad``; the update is the
  optimizer's, written into the model's parameters and the state's
  moments in place (the JAX package donates the old state's buffers to
  its jitted step to the same end).  With a mesh in the runtime the
  parameters are DTensors and every rank passes the same global batch:
  each takes its rows over the dp axes, and each gradient comes back on
  its parameter's placements (an FSDP shard's through a reduce-scatter,
  which DTensor's backward of the all-gather makes).
* :func:`make_compressed_train_step`, explicit data parallelism: each rank
  holds the whole model as plain tensors, takes its rows of the batch over
  one mesh axis, and the gradients are averaged over that axis by
  :func:`compressed_psum`, an int8 all-reduce with error-feedback
  residuals (:func:`init_residuals`), the JAX package's wire protocol.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..data.pipeline import to_device
from ..models import collectives as C
from ..models.convert import jax_path
from ..models.runtime import distribute, placements, resolve_device
from ..models.transformer import mesh_context
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
    """Raise unless every parameter is on ``device`` or is a ``meta``
    DTensor (the dry-run's stand-in on a mesh)."""
    from torch.distributed.tensor import DTensor
    for name, p in model.named_parameters():
        if p.is_meta and isinstance(p, DTensor):
            continue
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


def shard_batch(batch: dict, rt) -> dict:
    """Each leaf of a global batch (the same on every rank, on the mesh's
    device type) as a DTensor with its rows over the dp axes (where they
    divide them); the batch itself without a mesh."""
    if rt.mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        dp = rt.dp_axes if v.shape[0] % rt.size(rt.dp_axes) == 0 else None
        spec = (dp or None,) + (None,) * (v.ndim - 1)
        out[k] = distribute(v, rt.mesh, placements(spec, rt.mesh))
    return out


def _local(t):
    """A replicated DTensor's value as a plain tensor; anything else as
    it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def value_and_grads(api, rt, model, batch: dict, names=None, params=None):
    """(loss, metrics, {name: gradient}) of ``api.loss`` on ``batch``: on
    a mesh the batch's rows over the dp axes, the loss and metrics as
    plain tensors and each gradient on its parameter's placements."""
    if names is None:
        names, params = zip(*model.named_parameters())
    batch = shard_batch(batch, rt)
    with mesh_context(rt):
        loss, metrics = api.loss(model, batch, rt)
        gs = torch.autograd.grad(loss, params, allow_unused=True,
                                 materialize_grads=True)
    if rt.mesh is not None:
        gs = [g.redistribute(p.device_mesh, p.placements)
              for g, p in zip(gs, params)]
    return _local(loss.detach()), \
        {k: _local(v.detach()) for k, v in metrics.items()}, \
        dict(zip(names, gs))


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

    def step(state: TrainState, batch: dict):
        _check_device(state.model, device)
        batch = to_device(batch, device)
        names, params = zip(*state.model.named_parameters())
        if accum == 1:
            loss, metrics, grads = value_and_grads(api, rt, state.model,
                                                   batch, names, params)
        else:
            grads, loss, mets = None, 0.0, []
            for mb in _split_microbatches(batch, accum):
                l, m, g = value_and_grads(api, rt, state.model, mb, names,
                                          params)
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
        with mesh_context(rt):
            gnorm = opt.update_(grads, state.opt, dict(zip(names, params)))
        state.step += 1
        return state, {**metrics, "loss": loss, "grad_norm": _local(gnorm)}

    return step


# --------------------------------------------------------------------------
# gradient compression (int8 quantised all-reduce with error feedback)
# --------------------------------------------------------------------------
def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantisation. Returns (q, scale)."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_psum(x, residual, *, mesh, axis: str, n_shards: int):
    """int8 mean-all-reduce of ``x`` over ``axis`` with error feedback ->
    (the mean, the new residual).

    The JAX package's wire protocol:
      1. max of the local absmax over the axis -> one shared f32 scale;
      2. quantise to int8, all-to-all the int8 chunks (1 B an element);
      3. local int32 sum of the chunk this rank owns, the mean requantised
         to int8;
      4. all-gather the int8 partial means (1 B an element).
    What this rank failed to send (its input less its dequantised int8)
    stays local as the residual, added to the next step's gradient.
    """
    xc = x.float() + residual
    shape = xc.shape
    flat = xc.reshape(-1)
    n = flat.numel()
    pad = -n % n_shards
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    scale = C.all_reduce(flat.abs().max(), "max", mesh, axis) / 127.0 \
        + 1e-30
    q = torch.round(flat / scale).clamp(-127, 127).to(torch.int8)
    recv = C.all_to_all(q.reshape(n_shards, -1), mesh, axis)
    part = recv.to(torch.int32).sum(0)                # my chunk's sum
    mean_chunk = part.float() / n_shards              # in scale units
    q2 = torch.round(mean_chunk).clamp(-127, 127).to(torch.int8)
    full = C.all_gather(q2, mesh, axis).float() * scale
    out = full[:n].reshape(shape)
    new_residual = xc - q.float()[:n].reshape(shape) * scale
    return out, new_residual


def compressed_grads(grads: dict, residuals: dict, *, mesh, axis: str,
                     n_shards: int) -> tuple[dict, dict]:
    """:func:`compressed_psum` of every gradient leaf of the JAX layout:
    the port's per-layer gradients of one stacked JAX leaf
    (``layers.0.attn.wq``, ``layers.1.attn.wq``, ...) are stacked in index
    order and sent as one tensor, so they share one scale, as there.
    Returns the averaged gradients and the new residuals by name."""
    groups: dict[str, list[str]] = {}
    for name in grads:
        groups.setdefault(jax_path(name)[0], []).append(name)
    out, res = {}, {}
    for names in groups.values():
        names = sorted(names, key=lambda n: jax_path(n)[1])
        g = torch.stack([grads[n] for n in names])
        r = torch.stack([residuals[n] for n in names])
        mean, new = compressed_psum(g, r, mesh=mesh, axis=axis,
                                    n_shards=n_shards)
        for i, n in enumerate(names):
            out[n], res[n] = mean[i], new[i]
    return out, res


def init_residuals(model_or_params) -> dict:
    """Zero error-feedback residuals (f32), one a parameter."""
    named = (dict(model_or_params.named_parameters())
             if isinstance(model_or_params, nn.Module)
             else dict(model_or_params))
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}


def make_compressed_train_step(api, rt, opt: AdamW, *, mesh, axis: str,
                               n_shards: int, device="cuda"):
    """Data-parallel train step with the int8-compressed gradient
    all-reduce: step(state, residuals, batch) -> (state, residuals,
    metrics).  Every rank holds the whole model as plain tensors and the
    same global batch; each takes its rows over ``axis`` (its rank along it
    of ``n_shards``), computes its gradients with no mesh in the runtime,
    and averages them over ``axis`` with :func:`compressed_psum`; the loss
    and metrics are averaged over it too, and every rank applies the same
    update."""
    import dataclasses
    device = resolve_device(device, "make_compressed_train_step")
    rt = dataclasses.replace(rt, mesh=None, dp_axes=(), tp_axis=None,
                             ep_axis=None, moe_impl="local",
                             act_shard="none")

    def mean(t):
        return C.all_reduce(t, "sum", mesh, axis) / n_shards

    def step(state: TrainState, residuals: dict, batch: dict):
        _check_device(state.model, device)
        batch = to_device(batch, device)
        r = mesh.get_local_rank(axis)
        B = next(iter(batch.values())).shape[0]
        if B % n_shards:
            raise ValueError(f"batch {B} does not split over {n_shards} "
                             f"ranks")
        b = B // n_shards
        mb = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        names, params = zip(*state.model.named_parameters())
        loss, metrics = api.loss(state.model, mb, rt)
        gs = torch.autograd.grad(loss, params, allow_unused=True,
                                 materialize_grads=True)
        grads, new_res = compressed_grads(
            dict(zip(names, gs)), residuals, mesh=mesh, axis=axis,
            n_shards=n_shards)
        loss = mean(loss.detach())
        metrics = {k: mean(v.detach()) for k, v in metrics.items()}
        gnorm = opt.update_(grads, state.opt, dict(zip(names, params)))
        state.step += 1
        return state, new_res, {**metrics, "loss": loss, "grad_norm": gnorm}

    return step
