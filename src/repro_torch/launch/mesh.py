"""Process groups and device meshes for the LM mesh.

The PyTorch port of the JAX package's ``launch/mesh.py``.  A JAX mesh is a
grid of the devices of one process; here it is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over a process
group, one process a rank (SPMD): every rank runs the same program on its
own shard.  Functions, not module-level constants, so importing this
module touches no process group.

* :func:`init_process_group`: from ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or for ranks that a
  caller spawns, with the rank, the world size and a rendezvous
  (``tcp://localhost:<port>`` or ``file://<path>``).  The caller names
  the backend: ``gloo`` on the CPU, ``nccl`` with a card a rank; nothing
  switches backend when one fails.  NCCL refuses two ranks on one card,
  so an ``nccl`` world larger than the visible cards raises.  In a
  ``gloo`` world a gloo group's functional all-gather becomes an
  all-to-all (``models/collectives.py::route_all_gathers``: gloo's
  functional all-gather crashes on CUDA tensors).
* :func:`make_mesh_spec`: a (data, model) or (pod, data, model) mesh;
  the world must be exactly their product.
* :func:`make_host_mesh`: an (n, 1) (data, model) mesh; n is the explicit
  count, else ``REPRO_MESH_DEVICES``, else the world size.
* :func:`make_production_mesh`: the JAX package's production mesh, 16 x
  16 (data, model), or two such pods (pod, data, model).
* :func:`join_fake_world`: this process as rank 0 of a world of n ranks
  that do not exist (PyTorch's ``fake`` backend: its collectives return at
  once and move nothing), for the dry-run (``launch/dryrun.py``), which
  runs rank 0's step on ``meta`` tensors.  A torch without the backend
  raises; nothing stands in for it.

A mesh holds ``cuda`` tensors unless the caller passes ``device="cpu"``
(the CPU tests); ``cuda`` without a visible card raises.  Gloo runs on
CUDA tensors too, its ranks sharing a card.

"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_process_group(backend: str = "gloo", *, rank: int | None = None,
                       world_size: int | None = None,
                       init_method: str | None = None) -> int:
    """Join the default process group (if not yet joined) and return this
    rank.  Without ``rank``/``world_size`` they come from ``torchrun``'s
    ``RANK``/``WORLD_SIZE``; without ``init_method`` the rendezvous is
    ``env://``.  With ``nccl`` each rank takes card ``LOCAL_RANK`` (or its
    rank), and a world with more ranks than cards raises before any
    group is made."""
    if not dist.is_initialized():
        _join(backend, rank, world_size, init_method)
    if dist.get_backend() == "gloo":
        from ..models.collectives import route_all_gathers
        route_all_gathers()
    return dist.get_rank()


def _join(backend: str, rank: int | None, world_size: int | None,
          init_method: str | None) -> None:
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    if backend == "nccl":
        check_cards(world_size)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)


def check_cards(world_size: int) -> None:
    """Raise unless there is a visible card for each of ``world_size``
    NCCL ranks."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > n:
        raise RuntimeError(
            f"{world_size} NCCL ranks need {world_size} visible CUDA cards, "
            f"and {n} are visible: NCCL refuses two ranks on one card "
            f"(\"Duplicate GPU detected\"); run fewer ranks, or gloo with "
            f"device type cuda")


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str):
    from torch.distributed.device_mesh import init_device_mesh

    from ..models.runtime import resolve_device
    device = resolve_device(device, "make_mesh_spec").type
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs "
                         f"{n} ranks, and the world has {world}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_mesh_spec(data: int, model: int, pod: int = 1, *,
                   device: str = "cuda"):
    """A (data, model) mesh, or (pod, data, model) with ``pod`` > 1, over
    the whole world (which must be their product), of ``device`` tensors
    (``cuda`` unless the caller asks for the CPU)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


def make_host_mesh(ndevices: int | None = None, *,
                   device: str = "cuda"):
    """An (n, 1) (data, model) mesh: n is ``ndevices``, else
    ``REPRO_MESH_DEVICES``, else the world size."""
    n = ndevices
    if n is None and os.environ.get("REPRO_MESH_DEVICES"):
        n = int(os.environ["REPRO_MESH_DEVICES"])
    if n is None:
        n = dist.get_world_size()
    return make_mesh_spec(n, 1, device=device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 (data, model), or with ``multi_pod`` 2 x 16 x 16 (pod,
    data, model): the JAX package's production mesh (a TPU v5e-256 pod, or
    two), over a world of 256 or 512 ranks."""
    if multi_pod:
        return make_mesh_spec(16, 16, pod=2, device=device)
    return make_mesh_spec(16, 16, device=device)


def join_fake_world(world_size: int) -> int:
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks (the default group; one a process) and return
    the world size.  Its collectives complete at once and move nothing, so
    a step on ``meta`` tensors runs as rank 0 would run it.  Raises where
    the installed torch has no ``fake`` backend."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"torch {torch.__version__} has no fake process-group backend "
            f"(torch.testing._internal.distributed.fake_pg): the dry-run "
            f"needs it") from e
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process "
                           "group; a fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    return world_size
