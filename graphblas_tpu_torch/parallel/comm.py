"""The collectives of the distributed layer, in one place.

Counterpart of the collectives the JAX layer's ``shard_map`` programs
use: ``psum``, ``pmax``/``pmin``, ``all_gather`` and ``ppermute``, plus
``broadcast`` (which the JAX layer writes as a ``psum`` of one rank's
masked block).  Each runs eagerly over one axis of a :class:`Mesh`
(``axis=None``: every rank of the mesh) and returns a new tensor; the
input is never written.

Transport is the default group's backend, chosen by the caller:

* nccl: CUDA tensors, one GPU per rank (``make_mesh`` refuses more
  ranks than GPUs);
* gloo with CPU tensors: as they are;
* gloo with CUDA tensors (several ranks on one card): each buffer is
  copied to host memory, carried, and copied back.  This staging is
  explicit, and counted as ``staged`` in the census.

No collective switches transport on its own.  Dtypes the backends do
not take travel in a wider or plain form and come back in their own:
bool as uint8, int16 as int32, complex as its real view.  Reductions
compare and add the storage values as stored (signed); the callers in
:mod:`.dist` map GraphBLAS monoids onto them (unsigned order, NaN,
LOR/LAND) or gather and fold.  ``ppermute`` posts all its sends and
receives together (``batch_isend_irecv``), so a ring of any size cannot
deadlock; along an axis of one rank it returns its inputs.

Every call is noted in :mod:`.introspect`'s census with its payload
bytes (what this rank puts in) and whether it was staged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from . import introspect
from .mesh import Mesh

__all__ = ["psum", "pmax", "pmin", "pprod", "all_gather", "broadcast",
           "ppermute"]


def _wire(x: torch.Tensor):
    """(x in a form every backend carries, the map back)."""
    dt = x.dtype
    if dt == torch.bool:
        return x.to(torch.uint8), lambda y: y != 0
    if dt == torch.int16:
        return x.to(torch.int32), lambda y: y.to(torch.int16)
    if dt.is_complex:
        return (torch.view_as_real(x.contiguous()),
                lambda y: torch.view_as_complex(y.contiguous()))
    return x.contiguous(), lambda y: y


def _send_buffer(mesh: Mesh, w: torch.Tensor, kind: str,
                 fresh: bool) -> torch.Tensor:
    """The buffer a collective carries: on the host when staged; a copy
    when the collective writes into it (``fresh``)."""
    introspect.note(kind, w.numel() * w.element_size(), mesh.staged)
    if mesh.staged:
        return w.cpu()
    return w.clone() if fresh else w


def _home(mesh: Mesh, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device) if mesh.staged else y


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis, op, kind: str):
    if x.dtype.is_complex and op != dist.ReduceOp.SUM:
        raise TypeError(f"{kind} of complex values: gather and fold")
    w, back = _wire(x)
    buf = _send_buffer(mesh, w, kind, fresh=True)
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return back(_home(mesh, buf, x))


def psum(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = "i"):
    """Sum over the ranks of ``axis`` (integers wrap at the storage
    width of the wire; the callers widen first where that matters)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM, "all_reduce_sum")


def pmax(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = "i"):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX, "all_reduce_max")


def pmin(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = "i"):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MIN, "all_reduce_min")


def pprod(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = "i"):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.PRODUCT,
                       "all_reduce_prod")


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = "i"):
    """Every rank's ``x`` (all of one shape) stacked in coordinate
    order along a new leading dimension."""
    w, back = _wire(x)
    buf = _send_buffer(mesh, w, "all_gather", fresh=False)
    outs = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(outs, buf, group=mesh.group(axis))
    return back(_home(mesh, torch.stack(outs), x))


def broadcast(x: torch.Tensor, mesh: Mesh, axis: Optional[str],
              src: int) -> torch.Tensor:
    """The ``x`` of the rank at coordinate ``src`` along ``axis``, on
    every rank of the axis (the others' ``x`` gives shape and dtype)."""
    w, back = _wire(x)
    buf = _send_buffer(mesh, w, "broadcast", fresh=True)
    dist.broadcast(buf, src=mesh.axis_ranks(axis)[src],
                   group=mesh.group(axis))
    return back(_home(mesh, buf, x))


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh,
             axis: Optional[str] = "i", shift: int = 1
             ) -> List[torch.Tensor]:
    """Rotate along ``axis``: each rank sends every tensor of ``xs`` to
    the rank ``shift`` places on and receives the same shapes from the
    rank ``shift`` places back (JAX ``ppermute`` with the ring
    permutation)."""
    d = mesh.axis_size(axis)
    if d == 1:
        return list(xs)
    ranks = mesh.axis_ranks(axis)
    c = ranks.index(mesh.rank)
    dst, src = ranks[(c + shift) % d], ranks[(c - shift) % d]
    group = mesh.group(axis)
    ops, recvs = [], []
    for x in xs:
        w, back = _wire(x)
        sbuf = _send_buffer(mesh, w, "ppermute", fresh=False)
        rbuf = torch.empty_like(sbuf)
        ops.append(dist.P2POp(dist.isend, sbuf, dst, group))
        ops.append(dist.P2POp(dist.irecv, rbuf, src, group))
        recvs.append((rbuf, back, x))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [back(_home(mesh, r, x)) for r, back, x in recvs]
