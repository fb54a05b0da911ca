"""The collectives the LM mesh calls itself, and a counter of them all.

Inside a ``local_map`` region (the attention, the expert-parallel MoE, the
compressed all-reduce) the port moves tensors between ranks with explicit
collectives over one mesh axis, the JAX package's ``shard_map``
primitives:

* ``psum`` / ``pmax`` -> :func:`all_reduce` (``"sum"`` / ``"max"``);
* tiled ``all_to_all`` on dim 0 -> :func:`all_to_all` (autograd: its
  gradient is the reverse exchange);
* tiled ``all_gather`` on dim 0 -> :func:`all_gather`;
* ``axis_index`` -> ``mesh.get_local_rank(axis)``.

Each is a ``torch.distributed._functional_collectives`` op on the axis's
process group, which the caller's backend runs (``gloo`` on the CPU or
on CUDA tensors of ranks that share a card, or one card a rank over
``nccl``).  One exception: gloo's functional all-gather, the one
DTensor's Shard -> Replicate redistributions issue, crashes the process
on CUDA tensors (SIGSEGV, torch 2.11), while its functional all-to-all
runs there.  So on a gloo group every all-gather of the port is an
all-to-all of its input tiled once a peer (:func:`gather`: the same
bytes on the wire, an n-fold copy of the input held): the helper's own,
and DTensor's once :func:`route_all_gathers` has put :func:`gather` in
the functional all-gather's place (``launch.mesh.init_process_group``
does, in a gloo world only).  Any other group, NCCL's, takes torch's
functional all-gather unchanged.  (c10d's ``all_gather_into_tensor``
runs on gloo's CUDA tensors too, but four gloo ranks on one H100 took
~1.3x as long for a 2 x 2 full-width Llama prefill through it.)

:class:`CollectiveCounter` is a ``TorchDispatchMode`` that counts every
collective a region launches, those that DTensor's redistributions make
inside it too, with the bytes of each one's local input, by kind.
"""
from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed._functional_collectives as funcol
from torch.utils._python_dispatch import TorchDispatchMode


def group(mesh, axis: str):
    """The (mesh, dim) that names ``axis``'s process group."""
    return (mesh, mesh.mesh_dim_names.index(axis))


def all_reduce(x: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """``op`` ("sum" | "max") of ``x`` over ``axis``, on every rank."""
    return funcol.wait_tensor(funcol.all_reduce(x, op, group(mesh, axis)))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-to-all on dim 0: block i of ``x`` goes to rank i of
    ``axis``, and block j of the result came from rank j.  Autograd's
    gradient is the same exchange of the output's gradient."""
    x = x.contiguous()
    return funcol.wait_tensor(funcol.all_to_all_single_autograd(
        x, None, None, group(mesh, axis)))


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-gather on dim 0 (no gradient)."""
    out = gather(x, 0, group(mesh, axis))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def _process_group(grp):
    """The process group of a functional collective's group argument
    where it is a (mesh, dim) pair (what DTensor and these helpers pass);
    None for any other form."""
    if isinstance(grp, tuple) and len(grp) == 2:
        return grp[0].get_group(grp[1])
    return None


def _gather(name: str):
    """The functional all-gather ``name`` with a gloo group's calls made
    an all-to-all; any other group's left to torch's."""
    original = getattr(funcol, name)

    def gather(self: torch.Tensor, gather_dim: int, group, tag: str = ""):
        """All-gather of ``self`` along ``gather_dim`` over ``group`` (the
        functional all-gather's signature).  On a gloo group: an
        all-to-all of the input tiled once a peer on dim 0, so block j of
        the exchange is rank j's input, then the blocks laid along
        ``gather_dim``."""
        import torch.distributed as dist
        pg = _process_group(group)
        if pg is None or dist.get_backend(pg) != "gloo":
            return original(self, gather_dim, group, tag)
        x = self.contiguous()
        if x.dim() == 0:
            x = x.reshape(1)
        n = pg.size()
        tiled = x.repeat(n, *([1] * (x.dim() - 1)))      # contiguous
        out = funcol.wait_tensor(funcol.all_to_all_single(tiled, None, None,
                                                          group, tag))
        if gather_dim != 0:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out
    return gather


#: the functional all-gathers that :func:`route_all_gathers` replaces
#: (``all_gather_single`` is ``all_gather_tensor``'s newer name), each
#: routed by :func:`_gather`
_ROUTED = {name: _gather(name) for name in ("all_gather_tensor",
                                             "all_gather_single")
           if hasattr(funcol, name)}
gather = next(iter(_ROUTED.values()))


def route_all_gathers() -> None:
    """Put :func:`gather` in the functional all-gather's place (which
    DTensor calls for every Shard -> Replicate redistribution, forward and
    backward), in this process: a gloo group's all-gathers then run as
    all-to-alls."""
    for name, fn in _ROUTED.items():
        setattr(funcol, name, fn)


#: the functional and c10d ops that move data between ranks -> their kind
_KINDS = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "allreduce_": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_out": "all_gather",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "all_to_all_single": "all_to_all", "alltoall_base_": "all_to_all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives run under it, by kind: ``counts[kind]`` and
    ``bytes[kind]``, the bytes of each launch's local input.  DTensor's own
    collectives are seen too: on a DTensor op the mode steps aside
    (``NotImplemented``) so DTensor desugars it, and the collectives it
    issues come back through the mode."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        kind = _KINDS.get(func._overloadpacket.__name__) \
            if ns in ("_c10d_functional", "c10d", "c10d_functional") \
            else None
        if kind is not None:
            x = args[0]
            if isinstance(x, (list, tuple)):
                x = x[0] if x else None
            if isinstance(x, (list, tuple)):
                x = x[0] if x else None
            self.counts[kind] += 1
            if isinstance(x, torch.Tensor):
                self.bytes[kind] += x.numel() * x.element_size()
        return out

    def report(self) -> dict:
        """{kind: {"count", "bytes"}}, kinds sorted."""
        return {k: {"count": self.counts[k], "bytes": self.bytes[k]}
                for k in sorted(self.counts)}
