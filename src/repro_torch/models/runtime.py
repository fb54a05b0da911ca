"""Runtime: how a model executes (orthogonal to ModelConfig).

The PyTorch port of the JAX package's ``models/runtime.py``:
``ModelConfig`` says *what* the network is; ``Runtime`` says how it runs:
which mesh axes exist (a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims, one process a rank), how the MoE layer dispatches (``local``,
or expert-parallel ``ep``/``ep_a2a`` on a mesh), which attention path
prefill takes, the SSD scan's chunk, and for training the remat policy and
the loss chunk.  The launcher builds one from a
:class:`repro_torch.launch.plans.ParallelPlan`.

On a mesh, the parameters and activations are DTensors: a JAX
``PartitionSpec`` (an axis name, a tuple of names or ``None`` a tensor
dim) becomes DTensor placements through :func:`placements` (``Shard(d)``
on each mesh dim that tensor dim ``d`` names, else ``Replicate()``), and
:meth:`Runtime.constrain`, the JAX package's ``with_sharding_constraint``,
is ``DTensor.redistribute`` to them.  Every family runs on a mesh.  A
mesh's tensors lie on its device type, or are ``meta`` tensors: the
dry-run's stand-ins (``launch/dryrun.py``), which hold no data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

ATTN_MODES = ("dense", "chunked", "auto")
MOE_IMPLS = ("local", "ep", "ep_a2a")
ACT_SHARDS = ("none", "seq")


def _names(entry) -> tuple[str, ...]:
    """The mesh axes a spec entry names: None, one name, or a tuple."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def placements(spec, mesh, partial=()) -> tuple:
    """A spec (one entry a tensor dim) -> DTensor placements on ``mesh``:
    ``Shard(d)`` on each mesh dim that entry ``d`` names, ``Partial()``
    (a sum) on the axes ``partial`` names, ``Replicate()`` on the others.
    A mesh dim named twice raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for a in _names(partial):
        out[names.index(a)] = Partial()
    for d, entry in enumerate(spec):
        for a in _names(entry):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """``t``, the same full tensor on every rank, as a DTensor on ``mesh``
    with placements ``pl``: each rank keeps its own shard of its copy and
    nothing is sent.  A tensor on another device type than the mesh's
    raises: nothing is moved between the host and a card here."""
    from torch.distributed.tensor import distribute_tensor
    check_mesh_device(t, mesh)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def check_mesh_device(t: torch.Tensor, mesh) -> None:
    """Raise unless ``t`` lies on ``mesh``'s device type or is a ``meta``
    tensor (the dry-run's stand-ins, which hold no data to move)."""
    if t.device.type not in (mesh.device_type, "meta"):
        raise ValueError(
            f"a {t.device.type} tensor cannot go onto a {mesh.device_type} "
            f"mesh: move it to {mesh.device_type} first, or build the mesh "
            f"with device={t.device.type!r}")


def axis_size(mesh, axes) -> int:
    """The product of the widths of ``axes`` (a name, a tuple or None)."""
    n = 1
    for a in _names(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


@dataclass(frozen=True)
class Runtime:
    attn_mode: str = "auto"             # dense | chunked | auto
    mesh: Any = None                    # DeviceMesh | None
    dp_axes: tuple[str, ...] = ()       # batch-sharding axes ("pod","data")
    tp_axis: str | None = None          # tensor-parallel axis ("model")
    ep_axis: str | None = None          # expert-parallel axis (defaults tp)
    moe_impl: str = "local"             # local | ep | ep_a2a
    ssd_chunk: int = 256                # tokens a chunk of the SSD scan
    remat: bool = False                 # recompute each layer in backward
    remat_group: int = 1                # layers per remat block (g>1: save
                                        # only every g-th residual)
    act_shard: str = "none"             # none | seq: residual stream
                                        # sequence-sharded over tp
    loss_chunk: int = 0                 # 0 = unchunked cross-entropy

    def __post_init__(self):
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, got "
                             f"{self.attn_mode!r}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                             f"{self.moe_impl!r}")
        if self.act_shard not in ACT_SHARDS:
            raise ValueError(f"act_shard must be one of {ACT_SHARDS}, got "
                             f"{self.act_shard!r}")
        if self.ssd_chunk < 1:
            raise ValueError(f"ssd_chunk must be >= 1, got {self.ssd_chunk}")
        if self.remat_group < 1:
            raise ValueError(f"remat_group must be >= 1, got "
                             f"{self.remat_group}")
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be >= 0, got "
                             f"{self.loss_chunk}")
        if self.mesh is not None:
            names = tuple(self.mesh.mesh_dim_names or ())
            for a in self.dp_axes + tuple(
                    x for x in (self.tp_axis, self.ep_axis) if x):
                if a not in names:
                    raise ValueError(f"axis {a!r} is not a dim of the mesh "
                                     f"{names}")

    def size(self, axes) -> int:
        """The width of ``axes`` on the mesh (1 without one)."""
        return 1 if self.mesh is None or not axes else axis_size(self.mesh,
                                                                 axes)

    def constrain(self, x, *spec):
        """``x`` redistributed to ``spec``'s placements on the mesh (the
        JAX package's ``with_sharding_constraint``), an entry dropped where
        its axes do not divide the dim; ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh, self._fit(x, spec))

    def _fit(self, x, spec) -> tuple:
        """``spec``'s placements for ``x``: a dim its axes do not divide
        stays whole (a decode step's one position under
        act_shard="seq")."""
        return placements(tuple(e if x.shape[d] % self.size(e) == 0
                                else None for d, e in enumerate(spec)),
                          self.mesh)

    def residual(self, x, y):
        """The stream ``x`` plus a block's output ``y``.  On a mesh ``y``
        is put on the stream's placements (``act_spec``: its partial sums
        over tp reduced, Megatron's g) and its gradient is made whole over
        tp on the way back, so the output projection that made ``y``
        multiplies a whole gradient by its weight's shard.  DTensor, left
        to itself, meets a partial gradient there with an all-gather of
        the weight, and every rank multiplies the whole weight."""
        if self.mesh is None:
            return x + y
        spec = self.act_spec(y.ndim)
        whole = (spec[0],) + (None,) * (y.ndim - 1)
        return x + _ToStream.apply(y, self._fit(y, spec),
                                   self._fit(y, whole))

    def act_spec(self, ndim: int):
        """Activation spec for the (B, S, ...) residual stream: batch over
        dp axes; sequence over tp when act_shard == 'seq'."""
        seq = (self.tp_axis if (self.act_shard == "seq" and self.tp_axis)
               else None)
        if ndim < 2:
            return (self.dp_axes,) + (None,) * (ndim - 1)
        return (self.dp_axes, seq) + (None,) * (ndim - 2)


class _ToStream(torch.autograd.Function):
    """A DTensor redistributed to ``fwd`` placements, its gradient to
    ``bwd`` ones (:meth:`Runtime.residual`)."""

    @staticmethod
    def forward(ctx, y, fwd, bwd):
        ctx.bwd = bwd
        return y.redistribute(y.device_mesh, fwd)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.bwd), None, None


LOCAL = Runtime()


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``.  The LM path's entry points take
    ``"cuda"`` unless the caller passes another device, and ``cuda``
    without a visible card raises rather than run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(dev)!r}) needs a visible CUDA card and none "
            f"is available; pass device='cpu' to run the plain PyTorch path "
            f"on the CPU")
    return dev
