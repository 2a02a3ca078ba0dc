"""Distributed padded CSR: memory-scalable sharding for large graphs.

Counterpart of ``graphblas_tpu/parallel/dist_csr.py``.  The dense-block
``DistMatrix`` costs O(n²/d) device memory a rank; large graphs need
O(nnz/d).  Here each rank of a 1-D mesh holds a CSR slab of rows, its
arrays padded to the largest slab's entry count (so that the ring of
:mod:`.dist_spgemm` can rotate slabs of one shape):

* ``dist_csr_mxv``: y = A *.sr* x for any semiring (a user-defined one
  too), A row-slabbed and x on every rank; each rank computes its rows
  with the edge-parallel SpMV of :mod:`sparse.spmv` (gather, multiply,
  segment reduce; rows with no entry hold the add identity), and one
  ``all_gather`` puts y on every rank, ready to be the next
  iteration's x (the frontier exchange of BFS/PageRank).

The sharded masked SpGEMM (B slabs rotating around the ring) is in
:mod:`.dist_spgemm`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.matrix import Matrix, device_values
from ..core.semirings import Semiring, semiring
from ..core.types import FP32, FP64, Type, cast, tree_where
from ..sparse.spmv import _as_storage, _mult_apply, segment_fold
from ..utils.tree import tree_map
from . import comm, introspect
from .mesh import Mesh, make_mesh, pad_to_multiple

__all__ = ["DistCsr", "dist_csr_from_matrix", "dist_csr_mxv",
           "dist_csr_pagerank", "dist_csr_bfs"]


class DistCsr:
    """This rank's row slab of a CSR matrix over a 1-D mesh.

    rowptr:  [blk+1] int32 (the slab's indptr)
    indices: [nzpad] int32 (column ids; ncols = the sentinel)
    locrow:  [nzpad] int32 (row id within the slab; blk = the sentinel)
    values:  [nzpad] in the type's storage (a dict per field for a
             user-defined type)

    ``nzpad`` is the same on every rank.  ``starts`` holds the slab row
    boundaries when they were given (flop-balanced slabs for the ring
    SpGEMM), None for uniform slabs of ``blk`` rows."""

    def __init__(self, rowptr, indices, locrow, values, mesh: Mesh,
                 nrows: int, ncols: int, blk: int, type: Type,
                 starts=None):
        self.rowptr = rowptr
        self.indices = indices
        self.locrow = locrow
        self.values = values
        self.mesh = mesh
        self.nrows = nrows
        self.ncols = ncols
        self.blk = blk
        self.type = type
        self.starts = starts

    @property
    def ndev(self) -> int:
        return self.mesh.shape["i"]


def _tuples(A):
    """(I, J, X, nrows, ncols, type) of a bitmap Matrix or a sparse
    container, on the host."""
    if isinstance(A, Matrix):
        A = A.wait()
    I, J, X = A.extractTuples()
    return (np.asarray(I, np.int64), np.asarray(J, np.int64), X,
            A.shape[0], A.shape[1], A.type)


def dist_csr_from_matrix(A, mesh: Optional[Mesh] = None,
                         transpose: bool = False,
                         boundaries=None) -> DistCsr:
    """This rank's CSR slab of A's rows (A' 's rows with ``transpose``,
    the vxm form).  Takes a bitmap Matrix or a sparse container that
    every rank holds (no densifying).

    ``boundaries`` (length d+1, boundaries[0] = 0): explicit slab row
    boundaries for weight-balanced slabs (the ring SpGEMM cuts B's rows
    at equal flop weight, so that no hub slab holds up every ring
    step)."""
    mesh = mesh or make_mesh()
    return _slab_from_tuples(*_tuples(A), mesh, transpose, boundaries)


def _slab_from_tuples(I, J, X, nr: int, nc: int, t: Type, mesh: Mesh,
                      transpose: bool = False, boundaries=None) -> DistCsr:
    d = mesh.shape["i"]
    p = mesh.coord("i")
    nrows, ncols = (nc, nr) if transpose else (nr, nc)
    if transpose:
        I, J = J, I
        order = np.lexsort((J, I))
        I, J = I[order], J[order]
        X = tree_map(lambda v: np.asarray(v)[order], X)
    if boundaries is None:
        blk = pad_to_multiple(max(nrows, 1), d) // d
        dev = I // blk
        starts = None
        row0 = p * blk
    else:
        bnd = np.asarray(boundaries, np.int64)
        if len(bnd) != d + 1 or bnd[0] != 0 or bnd[-1] < nrows:
            raise ValueError(f"slab boundaries {bnd} for {nrows} rows on "
                             f"{d} ranks")
        dev = np.minimum(np.searchsorted(bnd[1:], I, side="right"), d - 1)
        blk = int(max((bnd[1:] - bnd[:-1]).max(), 1))
        starts = bnd
        row0 = int(bnd[p])
    nzpad = pad_to_multiple(max(int(np.bincount(dev, minlength=d).max()),
                                8), 128)
    sel = dev == p
    k = int(sel.sum())
    loc = (I[sel] - row0).astype(np.int32)
    rowptr = np.zeros(blk + 1, np.int32)
    rowptr[1:] = np.cumsum(np.bincount(loc, minlength=blk))
    indices = np.full(nzpad, ncols, np.int32)
    indices[:k] = J[sel]
    locrow = np.full(nzpad, blk, np.int32)
    locrow[:k] = loc
    dev_ = mesh.device

    def slab(v, ft):
        if ft.is_udt:
            return {f: slab(v[f], sub) for f, sub in ft.fields}
        out = np.zeros(nzpad, ft.dtype)
        out[:k] = np.asarray(v)[sel]
        return device_values(out, ft, dev_)
    return DistCsr(torch.from_numpy(rowptr).to(dev_),
                   torch.from_numpy(indices).to(dev_),
                   torch.from_numpy(locrow).to(dev_), slab(X, t), mesh,
                   nrows, ncols, blk, t, starts)


def _local_spmv(sr: Semiring, D: DistCsr, x_ext):
    """This slab's rows of y = A *.sr* x: gather x at the columns,
    multiply, reduce by row (padded lanes and empty rows hold the add
    identity)."""
    cols = D.indices.long()
    seg = D.locrow.clamp(max=D.blk)
    zt = sr.ztype
    if zt.is_udt or D.type.is_udt:
        # the operands are already in the semiring's domains
        z = sr.mult(D.values, tree_map(lambda v: v[cols], x_ext))
    else:
        a = cast(D.values, sr.xtype, D.type)
        z = _mult_apply(sr, a, x_ext[cols]).to(zt.storage)
    ident = sr.add.identity_array((), D.indices.device)
    z = tree_where(D.locrow < D.blk, z, ident)
    y = segment_fold(sr.add, z, seg, D.blk + 1, zt)
    return tree_map(lambda v: v[:D.blk], y)


def dist_csr_mxv(D: DistCsr, x, sr: Optional[Semiring] = None):
    """y = A *.sr* x (default: plus_times in float32), x given whole on
    every rank (a numpy array or a tensor; a dict of field arrays, in
    the semiring's input domain, for a user-defined semiring); y comes
    back whole on every rank, the add identity where a row has no
    entry.  One ``all_gather`` a call."""
    if D.starts is not None:
        raise ValueError(
            "dist_csr_mxv requires uniform slabs; this DistCsr was built "
            "with explicit flop-balanced boundaries (ring SpGEMM use "
            "only)")
    mesh = D.mesh
    dev = mesh.device
    sr = sr or semiring.plus_times[FP32]
    if sr.ztype.is_udt or D.type.is_udt:
        x = tree_map(lambda v: torch.as_tensor(v).to(dev), x)
    else:
        x, xt = _as_storage(x, None, dev)
        x = cast(x, sr.ytype, xt)
    # the sentinel column's slot: its lanes are identity-washed, so any
    # value in the domain will do
    x_ext = tree_map(lambda v: torch.cat([v, torch.zeros(
        1, dtype=v.dtype, device=dev)]), x)
    with introspect.record("dist_csr_mxv", D.indices, D.locrow, D.values,
                           x):
        y = _local_spmv(sr, D, x_ext)
        y = tree_map(lambda v: comm.all_gather(v, mesh, "i").reshape(-1)[
            :D.nrows], y)
    return y


def _csr_drowscale(A, mesh: Mesh) -> DistCsr:
    """The slabs of C' for C = D*A, D(i,i) = 1 / sum(A(i,:)) (a bool
    A's entries count 1; an empty or zero-sum row keeps its values), as
    ``models.pagerank.drowscale`` of a bitmap A, in FP64."""
    I, J, X, nr, nc, t = _tuples(A)
    w = np.asarray(X, np.float64)
    rs = np.bincount(I, weights=w, minlength=nr)
    rs[rs == 0] = 1.0
    return _slab_from_tuples(I, J, w / rs[I], nr, nc, FP64, mesh,
                             transpose=True)


def dist_csr_pagerank(A, iters: int = 20,
                      mesh: Optional[Mesh] = None) -> np.ndarray:
    """PageRank over the sharded-CSR SpMV (one all_gather an
    iteration), as the JAX package's: r <- C' (0.85 r) + 0.15/n sum(r)
    in float32, C the row-scaled A.  Takes a bitmap Matrix or a sparse
    container."""
    mesh = mesh or make_mesh()
    D = _csr_drowscale(A, mesh)
    n = D.ncols
    with introspect.record("dist_csr_pagerank", D.indices, D.values):
        r = torch.full((n,), 1.0 / n, dtype=torch.float32,
                       device=mesh.device)
        a = (1 - 0.85) / n
        for _ in range(iters):
            s = a * float(r.sum())
            r = dist_csr_mxv(D, 0.85 * r) + s
    r = r.cpu().numpy()
    return r / r.sum()


def dist_csr_bfs(A, src: int, mesh: Optional[Mesh] = None) -> np.ndarray:
    """BFS levels (int64, 0 = unreached) over the sharded-CSR frontier
    SpMV.  Takes a bitmap Matrix or a sparse container."""
    mesh = mesh or make_mesh()
    D = dist_csr_from_matrix(A, mesh, transpose=True)
    n = D.nrows
    dev = mesh.device
    with introspect.record("dist_csr_bfs", D.indices, D.values):
        lev = torch.zeros(n, dtype=torch.int64, device=dev)
        q = torch.zeros(n, dtype=torch.float32, device=dev)
        q[src] = 1.0
        level = 1
        while level <= n and bool(q.any()):
            lev[q != 0] = level
            nxt = dist_csr_mxv(D, q)
            q = ((nxt != 0) & (lev == 0)).to(torch.float32)
            level += 1
    return lev.cpu().numpy()
