"""Design-axis sharding: one mesh, many devices, same numbers.

The port of the JAX package's ``core/shard.py``.  :class:`EvalMesh`
partitions the *design axis* of the evaluation programs across devices:
tables (``NetTables``, one board's ``DeviceTables``, ``MultiNetTables``)
are copied to every device, the rows of a ``DesignBatch`` (and of a
share plane) are split into equal shards, and tails are
padded to ``ndevices x tile`` so every shard holds a whole number of
tiles.  All evaluator arithmetic is row-local (reductions only run
*within* a design row), so the sharded call is bit-identical to the
single-device one; on one device the mesh is not used at all.

Each shard runs the single-device batch path on its device: on the card,
one ``parallelism_search`` launch per chunk of the shard, on the shard's
device.  :meth:`EvalMesh.shard_call` enqueues every shard before any result
is read and gathers the outputs on ``devices[0]``.

Device discovery honours ``REPRO_MESH_DEVICES``.  On ``cuda`` the visible
devices are every card, starting at the one the mesh is built for (a mesh
for ``cuda:1`` on three cards is ``cuda:1, cuda:2, cuda:0``), so the
outputs gather on the caller's own card.  torch cannot split the host
into devices as XLA's ``--xla_force_host_platform_device_count`` does, so
on ``cpu`` the visible devices are ``REPRO_MESH_DEVICES`` (when it is 2 or
more) copies of ``cpu``, else one: a device named N times is N shards of
it.  An explicit ``devices=`` list may repeat a device the same way, which
is how one card runs a 4-shard mesh.  A mesh on ``cuda`` without a
visible card raises.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ..kernels import launches
from .batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, _pad_rows,
                         evaluate_batch, padded_rows, search_setup)

MESH_ENV = "REPRO_MESH_DEVICES"
MESH_AXIS = "designs"


def env_mesh_devices() -> int | None:
    """Parse ``REPRO_MESH_DEVICES`` (None when unset/empty)."""
    raw = os.environ.get(MESH_ENV)
    if not raw:
        return None
    n = int(raw)
    if n < 1:
        raise ValueError(f"{MESH_ENV} must be >= 1, got {raw!r}")
    return n


def _visible_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh for ``device`` may use: every visible card,
    ``device``'s own first (the current card when it names none), or
    ``REPRO_MESH_DEVICES`` shards of the host (one when it is unset or
    below 2)."""
    device = torch.device(device)
    kind = device.type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an EvalMesh on cuda needs a visible CUDA "
                               "card and none is available; pass "
                               "device='cpu' to shard the host")
        n = torch.cuda.device_count()
        first = torch.cuda.current_device() if device.index is None \
            else device.index
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    if kind == "cpu":
        n = env_mesh_devices()
        return [torch.device("cpu")] * (n if n is not None and n >= 2
                                        else 1)
    raise ValueError(f"no mesh on {kind!r} devices; use cuda or cpu")


def _map(x, fn):
    """``x`` with ``fn`` applied to every tensor it holds (tensors, and
    dataclasses, named tuples, tuples, lists and dicts of them); anything
    else is returned as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        new = {f.name: _map(getattr(x, f.name), fn)
               for f in dataclasses.fields(x) if f.init}
        if all(new[k] is getattr(x, k) for k in new):
            return x
        return dataclasses.replace(x, **new)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    return x


def _leaves(x) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(x, lambda t: out.append(t) or t)
    return out


def _cat(parts: list, device):
    """Row-concatenate shard outputs of one structure on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts], device) for k in first}
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _cat([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_cat(list(c), device) for c in zip(*parts)))
    if isinstance(first, (tuple, list)):
        return type(first)(_cat(list(c), device) for c in zip(*parts))
    return first


class EvalMesh:
    """A 1-D device mesh over the design axis.

    ``ndevices`` resolution order: explicit argument, then
    ``REPRO_MESH_DEVICES``, then every visible device of ``device``'s kind,
    ``device`` itself first (:func:`_visible_devices`).  A request beyond
    the visible device count clamps (recorded in ``requested``): asking
    for 8 devices on a 1-device host lands on the single-device path, it
    is not an error.
    ``devices``, when given, is the mesh verbatim, and may name one device
    more than once.
    """

    def __init__(self, ndevices: int | None = None, *, devices=None,
                 device="cuda"):
        if devices is None:
            avail = _visible_devices(device)
            want = ndevices if ndevices is not None else env_mesh_devices()
            want = len(avail) if want is None else want
            if want < 1:
                raise ValueError(f"ndevices must be >= 1, got {want}")
            self.requested = want
            devices = avail[:min(want, len(avail))]
        else:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ValueError("an EvalMesh needs at least one device")
            if any(d.type == "cuda" for d in devices) \
                    and not torch.cuda.is_available():
                raise RuntimeError("an EvalMesh on cuda needs a visible "
                                   "CUDA card and none is available")
            devices = [torch.device("cuda", torch.cuda.current_device())
                       if d.type == "cuda" and d.index is None else d
                       for d in devices]
            self.requested = len(devices)
        self.devices = tuple(devices)
        #: kernel launches made by each shard, by kernel name, since the
        #: mesh was made or :meth:`reset_shard_launches` last ran
        self.shard_launches: list[dict[str, int]] = []
        self.reset_shard_launches()

    @property
    def ndevices(self) -> int:
        return len(self.devices)

    @property
    def is_sharded(self) -> bool:
        return self.ndevices > 1

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"EvalMesh(ndevices={self.ndevices}, "
                f"requested={self.requested})")

    def padded_rows(self, B: int, tile: int = DEFAULT_TILE) -> int:
        """Rows actually executed for a B-design sharded call."""
        return padded_rows(B, tile, self.ndevices)

    def reset_shard_launches(self) -> None:
        self.shard_launches = [dict.fromkeys(launches(), 0)
                               for _ in self.devices]

    # -- the generic sharded call ----------------------------------------
    def replicate(self, x) -> dict:
        """``x`` (tensors, or structures of them) copied once to each
        distinct device of the mesh, by device."""
        return {d: _map(x, lambda t, d=d: t.to(d))
                for d in dict.fromkeys(self.devices)}

    def run_shards(self, fn, parts) -> list:
        """``fn(*parts[s])`` for each shard ``s``, in order, the arguments
        already on ``devices[s]``; the launches each shard makes are added
        to its tally (``shard_launches``).  Nothing here reads a result, so
        every shard is enqueued before any is read.  Returns the outputs,
        each on its shard's device."""
        outs = []
        for s, part in enumerate(parts):
            before = launches()
            outs.append(fn(*part))
            tally = self.shard_launches[s]
            for k, v in launches().items():
                tally[k] = tally.get(k, 0) + v - before.get(k, 0)
        return outs

    def shard_call(self, fn, args, replicated=()):
        """``fn`` on each shard of ``args``, outputs row-concatenated on
        ``devices[0]``: the counterpart of the JAX package's ``shard_jit``.

        Positional argument ``i`` is copied whole to every distinct device
        of the mesh (once per call) when ``i in replicated``, else split
        into ``ndevices`` equal row parts, part ``s`` going to
        ``devices[s]``; every tensor such an argument holds must share one
        leading dimension.  Every shard is enqueued before any output is
        read.
        """
        args = tuple(args)
        repl = frozenset(replicated)
        nd = self.ndevices
        per = {}
        for i, a in enumerate(args):
            if i in repl:
                continue
            rows = {t.shape[0] for t in _leaves(a)}
            if len(rows) != 1 or next(iter(rows)) % nd:
                raise ValueError(
                    f"argument {i} must hold tensors of one leading "
                    f"dimension that splits into {nd} equal shards, got "
                    f"{sorted(rows)}; pad to mesh.padded_rows first")
            per[i] = next(iter(rows)) // nd
        copies = {i: self.replicate(args[i]) for i in repl}
        parts = [[copies[i][d] if i in repl else
                  _map(a, lambda t, d=d, n=per[i]:
                       t[s * n:(s + 1) * n].to(d))
                  for i, a in enumerate(args)]
                 for s, d in enumerate(self.devices)]
        return _cat(self.run_shards(fn, parts), self.devices[0])

    # -- the evaluator entry point ---------------------------------------
    def evaluate_padded(self, design, tables, devt, *, tile: int =
                        DEFAULT_TILE, chunk: int = DEFAULT_CHUNK,
                        fm_tile_rows: int = 2,
                        full_pes: float | None = None,
                        pairs=None) -> dict:
        """Sharded ``evaluate_batch``: pad rows to ``ndevices x tile``,
        shard the design axis, slice the pad back off.  The set-up (the
        board's tables and the pair list, ``batch_eval.search_setup``) is
        built once here and copied to every device with the net's tables,
        so a shard does no host-side work before its launches.  One board
        only, as in the JAX package: a per-row board raises."""
        B = design.batch
        if pairs is None:
            devt, pairs = search_setup(tables, devt, full_pes)
        if devt.per_row:
            raise ValueError("a sharded mesh evaluates one board; per-row "
                             "boards take the single-device path")
        padded = _pad_rows(design, self.padded_rows(B, tile))
        run = lambda d, t, dv, pr: evaluate_batch(
            d, t, dv, fm_tile_rows, tile=tile, chunk=chunk, pairs=pr)
        out = self.shard_call(run, (padded, tables, devt, pairs),
                              replicated=(1, 2, 3))
        return {k: v[:B] for k, v in out.items()}


__all__ = ["EvalMesh", "MESH_AXIS", "MESH_ENV", "env_mesh_devices"]
