"""Port of the JAX package's ``tpu/hlo_walk.py``: cost extraction from
an eager PyTorch step.

The JAX walker parses a compiled module's HLO and multiplies each
``while`` body by its trip count.  The port runs eagerly, so there is no
module to parse and no trip count to find: :class:`OpWalk` is a
``TorchDispatchMode`` that sees every aten op as it runs, each loop
iteration and each layer included, forward, backward and remat's
recompute alike::

    with OpWalk() as w:
        step(state, batch)
    w.costs().as_dict()      # the JAX walker's keys

What it counts, per device (a process drives one card):

* ``flops`` -- ``torch.utils.flop_counter``'s formula for every op it has
  one for (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions and
  their backward, the attention ops): the JAX walker's ``dot`` and
  ``convolution``.  Also kept by the operands' dtype (``flops_by_dtype``),
  because the port runs f32 products beside bf16 ones and the card's rates
  for the two differ by 15x.
* ``bytes_accessed`` -- every op that is not a view or a metadata op pays
  its tensor operands' bytes as read (numel x itemsize of the view it is
  given, never its base storage: a layer's slice of a stacked weight pays
  the slice, as in the JAX walker's dynamic-slice rule) plus its outputs'
  bytes.  The JAX walker charges only the ops XLA-TPU would not fuse
  (``_BYTES_OPS``); the port runs eagerly, so each kernel really reads its
  operands from HBM and writes its output back, and each op pays.
* ``transcendentals`` -- the output elements of every op whose math
  evaluates exp, log, tanh, sqrt/rsqrt, pow, sigmoid or SiLU, sin/cos,
  erf, expm1/log1p, atan2 or a softmax (the JAX walker's
  ``_TRANSCENDENTAL``).
* collectives -- the ``_c10d_functional`` ops and the ``c10d`` ops behind
  ``torch.distributed``'s calls: operand bytes, and wire bytes by the JAX
  walker's ring rules (all-reduce 2(n-1)/n, all-gather, reduce-scatter
  and all-to-all (n-1)/n of the larger side, a broadcast, send or receive
  as a collective-permute, 1x), with n the op's own group size.

On a mesh each count is this rank's: a DTensor's op is counted as the
ops it runs on the rank's shards and the collectives it issues (the walk
steps aside, ``NotImplemented``, and DTensor desugars the op), and the
ops that DTensor's sharding propagation runs on fake tensors of the
global shape are not counted.  :class:`MemCount` counts the bytes the
rank holds the same way.

Hand-written kernels are launched through ``ctypes`` and never pass the
dispatcher, so no mode sees them.  Each kernel's route function therefore
charges its kernel's cost by formula through :func:`charge`, on the card
and on the CPU alike, and the walk counts none of the aten ops run under
the charge (on the CPU the plain version's, on the card the output's
allocation).  So a walk counts the same on both routes.  ``charge`` finds
the walk through PyTorch's dispatch-mode stack, which autograd carries to
its device threads: a kernel launched in remat's recompute, in the
backward on a CUDA tensor, is charged to the walk all the same.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

#: ops that move no data and that PyTorch does not mark as views: they
#: allocate, reinterpret a buffer or wait on a collective
_FREE = {
    "aten.empty", "aten.empty_like", "aten.empty_strided",
    "aten.new_empty", "aten.new_empty_strided", "aten._unsafe_view",
    "aten.set_", "aten.resize_", "_c10d_functional.wait_tensor",
    "_c10d_functional._wrap_tensor_autograd",
}

#: ops whose math evaluates a transcendental function (``_`` for in place)
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log10", "tanh", "sqrt", "rsqrt", "pow",
    "sigmoid", "silu", "silu_backward", "sin", "cos", "erf", "erfc",
    "expm1", "log1p", "atan2", "_softmax", "_log_softmax", "logsumexp",
    "gelu", "gelu_backward", "softplus",
}

#: collective op -> (the JAX walker's kind, the positional argument that is
#: its input, the one it writes its output into, or None where the op
#: returns its output)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", 0, None),
    "_c10d_functional.all_reduce_": ("all-reduce", 0, None),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0, None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0, None),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0, None),
    "_c10d_functional.broadcast": ("collective-permute", 0, None),
    "_c10d_functional.broadcast_": ("collective-permute", 0, None),
    "c10d.allreduce_": ("all-reduce", 0, 0),
    "c10d.allgather_": ("all-gather", 1, 0),
    "c10d._allgather_base_": ("all-gather", 1, 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1, 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "c10d.alltoall_": ("all-to-all", 1, 0),
    "c10d.alltoall_base_": ("all-to-all", 1, 0),
    "c10d.broadcast_": ("collective-permute", 0, 0),
    "c10d.send": ("collective-permute", 0, None),
    "c10d.recv_": ("collective-permute", 0, 0),
}


def _subclasses() -> tuple[type, type]:
    """``DTensor`` and ``FakeTensor``, imported on first use."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    return DTensor, FakeTensor


def _is_fake(types, out, fake: type) -> bool:
    """Whether an op ran on fake tensors, or made one (a factory op has
    no tensor argument to tell)."""
    return any(issubclass(t, fake) for t in types) or any(
        isinstance(t, fake) for t in tree_leaves(out))


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or a list or tuple of
    them), each numel x itemsize of the view."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _group_size(args) -> int:
    """The size of the process group an op's arguments name: a group
    object, or a functional collective's group name."""
    for a in args:
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        size = getattr(a, "size", None)
        if callable(size) and not isinstance(a, torch.Tensor):
            return int(size())
    return 1


@dataclass
class WalkCosts:
    """What a finished walk counted, per device: the JAX walker's fields,
    and the port's own (FLOPs by dtype, the op census, FLOPs and bytes by
    op, the hand kernels' charges)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    coll_operand: dict = field(default_factory=dict)
    coll_wire: dict = field(default_factory=dict)
    coll_count: dict = field(default_factory=dict)
    flops_by_dtype: dict = field(default_factory=dict)
    census: dict = field(default_factory=dict)
    flops_by_op: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    charges: dict = field(default_factory=dict)

    @property
    def total_wire(self) -> float:
        return sum(self.coll_wire.values())

    def as_dict(self) -> dict:
        """The JAX walker's keys, and ``flops_by_dtype``."""
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "collective_operand_bytes": dict(self.coll_operand),
            "collective_wire_bytes": dict(self.coll_wire),
            "collective_counts": dict(self.coll_count),
            "total_wire_bytes": self.total_wire,
            "flops_by_dtype": dict(self.flops_by_dtype),
        }


class OpWalk(TorchDispatchMode):
    """Counts the FLOPs, bytes, transcendentals and collectives of every
    aten op run while it is active, on any thread autograd runs the step
    on, and the hand kernels' charges (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._c = WalkCosts()
        for name in ("coll_operand", "coll_wire", "coll_count",
                     "flops_by_dtype", "flops_by_op", "bytes_by_op"):
            setattr(self._c, name, defaultdict(float))
        self._c.census, self._c.charges = defaultdict(int), defaultdict(int)
        #: threads inside a charge, by thread id: their ops are the
        #: kernel's, already charged
        self._quiet: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtensor, fake = _subclasses()
        if any(issubclass(t, dtensor) for t in types):
            # a DTensor's op runs as ops on this rank's shards, which the
            # walk then sees and counts: the costs are a device's
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_fake(types, out, fake):
            # DTensor's sharding propagation runs the op on fake tensors of
            # the global shape, for the output's metadata alone
            return out
        if self._quiet.get(threading.get_ident()):
            return out
        name = str(func.overloadpacket)
        with self._lock:
            self._count(func, name, args, kwargs, out)
        return out

    def _count(self, func, name, args, kwargs, out) -> None:
        c = self._c
        c.census[name] += 1
        if name in _COLLECTIVES:
            self._collective(name, args, out)
            return
        if func.is_view or name in _FREE:
            return
        packet = func.overloadpacket
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            first = next((t for t in tree_leaves(args)
                          if isinstance(t, torch.Tensor)), None)
            dt = _dtype_name(first.dtype) if first is not None else "none"
            c.flops += flops
            c.flops_by_dtype[dt] += flops
            c.flops_by_op[name] += flops
        if packet.__name__.rstrip("_") in _TRANSCENDENTAL:
            first_out = next((t for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor)), None)
            if first_out is not None:
                c.transcendentals += first_out.numel()
        nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        c.bytes_accessed += nbytes
        c.bytes_by_op[name] += nbytes

    def _collective(self, name, args, out) -> None:
        kind, i_in, i_out = _COLLECTIVES[name]
        operand = _nbytes(args[i_in])
        result = _nbytes(out if i_out is None else args[i_out])
        n = _group_size(args)
        frac = (n - 1) / n if n > 1 else 0.0
        size = max(operand, result)
        c = self._c
        c.coll_count[kind] += 1
        c.coll_operand[kind] += operand or result
        if kind == "all-reduce":
            c.coll_wire[kind] += 2 * size * frac
        elif kind == "collective-permute":
            c.coll_wire[kind] += size
        else:
            c.coll_wire[kind] += size * frac
        c.bytes_accessed += operand + result
        c.bytes_by_op[name] += operand + result

    @contextlib.contextmanager
    def _charging(self, name: str, cost):
        tid = threading.get_ident()
        with self._lock:
            self._quiet[tid] = self._quiet.get(tid, 0) + 1
        try:
            got = cost()
            flops, nbytes = float(got["flops"]), float(got["bytes"])
            with self._lock:
                c = self._c
                c.flops += flops
                c.flops_by_dtype[_dtype_name(got["dtype"])] += flops
                c.flops_by_op[name] += flops
                c.bytes_accessed += nbytes
                c.bytes_by_op[name] += nbytes
                c.transcendentals += float(got["transcendentals"])
                c.charges[name] += 1
            yield
        finally:
            with self._lock:
                self._quiet[tid] -= 1

    def costs(self) -> WalkCosts:
        """A copy of what the walk has counted so far."""
        with self._lock:
            c = self._c
            return WalkCosts(
                flops=c.flops, bytes_accessed=c.bytes_accessed,
                transcendentals=c.transcendentals,
                **{k: dict(getattr(c, k)) for k in (
                    "coll_operand", "coll_wire", "coll_count",
                    "flops_by_dtype", "census", "flops_by_op",
                    "bytes_by_op", "charges")})


class MemCount(TorchDispatchMode):
    """The bytes a device holds while a step runs, counted from the
    tensors its aten ops make (``meta`` tensors too, which hold none): a
    ``TorchDispatchMode`` for the dry-run, where no allocator can be asked.

    Each op's output storages are live from the op that made them to the
    death of the last tensor that holds them (a weak reference's
    callback); :meth:`hold` registers the step's arguments (parameters,
    optimizer state, batch, cache) first.  A DTensor's op is counted as
    the ops on this rank's shards, as :class:`OpWalk` counts it, and the
    fake tensors of DTensor's sharding propagation not at all.  What it
    cannot see: the allocator's rounding and caching, workspaces a
    library allocates inside a call, and a hand kernel's scratch."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._live: dict[int, list] = {}       # storage -> [bytes, refs]
        self.now = self.peak = self.held = 0

    def hold(self, tensors) -> None:
        """Count ``tensors`` (a tree of tensors or DTensors, their local
        shards) as live arguments, each its own elements' bytes (a shard
        cut from a whole tensor that every rank holds is a view of it)."""
        for t in tree_leaves(tensors):
            if isinstance(t, _subclasses()[0]):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                self._track(t, t.numel() * t.element_size())
        self.held = self.now

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtensor, fake = _subclasses()
        if any(issubclass(t, dtensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not _is_fake(types, out, fake):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def _track(self, t: torch.Tensor, nbytes: int | None = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            e = self._live.get(key)
            if e is None:
                e = self._live[key] = [st.nbytes() if nbytes is None
                                       else nbytes, 0]
                self.now += e[0]
                self.peak = max(self.peak, self.now)
            e[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        with self._lock:
            e = self._live.get(key)
            if e is None:
                return
            e[1] -= 1
            if e[1] == 0:
                self.now -= e[0]
                del self._live[key]

    def memory(self) -> dict:
        """The JAX dry-run's memory keys for one device: the arguments
        held, the bytes made in the step and still live (its outputs), the
        most made beyond the arguments at once, and the peak."""
        with self._lock:
            out = max(self.now - self.held, 0)
            return {"argument_size_in_bytes": int(self.held),
                    "output_size_in_bytes": int(out),
                    "temp_size_in_bytes": int(max(self.peak - self.held
                                                  - out, 0)),
                    "peak_memory_in_bytes": int(self.peak)}


_NO_CHARGE = contextlib.nullcontext()


def charge(name: str, cost):
    """A context manager around a hand kernel's route: inside a walk (the
    innermost ``OpWalk`` on this thread's dispatch-mode stack) it charges
    ``cost()`` (a dict of ``flops``, ``bytes``, ``transcendentals`` and a
    torch ``dtype``, computed only then) to the walk under ``name`` and
    counts none of the aten ops run inside it; outside a walk it does
    nothing."""
    if torch._C._len_torch_dispatch_stack():
        for mode in reversed(_get_current_dispatch_mode_stack()):
            if isinstance(mode, OpWalk):
                return mode._charging(name, cost)
    return _NO_CHARGE
