"""Rank meshes over ``torch.distributed`` and placement specs.

Counterpart of ``graphblas_tpu/parallel/mesh.py``.  The JAX layer is
single-controller: one process holds a ``jax.sharding.Mesh`` of devices
and each operation is one compiled SPMD program.  Here the layer is
multi-controller: one process per rank (started by
:func:`graphblas_tpu_torch.parallel.launch.run_world` or by the caller's
own ``init_process_group``), and a :class:`Mesh` is each rank's view of
a ``DeviceMesh`` over the default process group: its process group per
axis, its coordinates, and the device its shards live on.

The transport is the default group's backend, named by whoever started
the ranks: NCCL carries CUDA tensors and needs one GPU per rank; gloo
carries CPU tensors, and CUDA shards under gloo are staged through host
memory by :mod:`.comm`, explicitly and counted.  Nothing switches from
one to the other.

``P`` is a plain placement spec (one entry per dimension: an axis name
or None for a replicated dimension), the counterpart of JAX's
``PartitionSpec``; ``NamedSharding`` pairs it with a mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "row_sharding", "replicated", "P", "Mesh",
           "NamedSharding", "pad_to_multiple"]


class P(tuple):
    """A placement spec: ``P("i", None)`` shards dimension 0 over the
    mesh axis "i" and replicates dimension 1; ``P()`` replicates all."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:  # pragma: no cover
        return f"P{tuple(self)!r}"


class NamedSharding(NamedTuple):
    mesh: "Mesh"
    spec: P


class Mesh:
    """One rank's view of a rank mesh: ``shape`` maps each axis name to
    its size, ``devices`` holds the ranks laid out in the mesh's shape
    (as JAX's ``Mesh.devices`` holds devices), ``device`` is where this
    rank's shards live, ``backend`` the default group's transport."""

    def __init__(self, device_mesh, axis_names: Sequence[str],
                 shape: Tuple[int, ...], device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self._coords = dict(zip(self.axis_names,
                                device_mesh.get_coordinate()))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def staged(self) -> bool:
        """True when collectives cross host memory: gloo with CUDA
        shards."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coords[axis]

    def coords_of(self, rank: int) -> dict:
        """The coordinates of any rank of the mesh."""
        return dict(zip(self.axis_names,
                        np.unravel_index(rank, self.devices.shape)))

    def group(self, axis: Optional[str]):
        """The process group along ``axis`` (None: the whole mesh)."""
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def axis_ranks(self, axis: Optional[str]) -> list:
        """The global ranks along ``axis`` through this rank, in
        coordinate order (None: every rank)."""
        if axis is None:
            return list(range(self.size))
        return dist.get_process_group_ranks(self.group(axis))

    def axis_size(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[axis]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Mesh({self.shape}, rank {self.rank} on {self.device}, "
                f"{self.backend})")


def _rank_device(device) -> torch.device:
    """This rank's device: the CUDA card ``rank % device_count`` unless
    the caller names the CPU; without a card that raises, as
    ``sparse.container.resolve_device`` does."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: graphblas_tpu_torch runs on the card by "
            "default; pass device=\"cpu\" to work on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("i",), device=None) -> Mesh:
    """A mesh over every rank of the initialized default process group
    (``n_devices``, if given, must equal the world size).

    1-D ``("i",)`` meshes row-shard matrices; 2-D ``("i","j")`` meshes
    block-shard them (SUMMA-style mxm).  Every rank calls it alike."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with parallel.run_world "
            "or torch.distributed.init_process_group")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}: every rank of the world takes part")
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        # factor n_devices as evenly as possible for a 2-D mesh
        a = int(np.floor(np.sqrt(n_devices)))
        while n_devices % a:
            a -= 1
        shape = (a, n_devices // a)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not hold {world} ranks")
    dev = _rank_device(device)
    backend = dist.get_backend()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend carries CUDA tensors only; "
                             "start a gloo world for CPU shards")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs one GPU per rank: {world} ranks, "
                f"{torch.cuda.device_count()} GPUs; start a gloo world to "
                f"run several ranks on one card (its collectives are "
                f"staged through host memory)")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=tuple(axis_names))
    return Mesh(dm, axis_names, shape, dev)


def row_sharding(mesh: Mesh, ndim: int = 2,
                 axis: str = "i") -> NamedSharding:
    """Shard dim 0 over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, d: int) -> int:
    """``n`` rounded up to a multiple of ``d``: the equal sizes a
    collective needs (gathered blocks, the ring's slabs)."""
    return ((n + d - 1) // d) * d
