"""SpMM: CSR sparse matrix x dense matrix, dense output.

Counterpart of ``graphblas_tpu/sparse/spmm.py``.  One gather of a
k-wide row of the dense right operand serves k products, so a dense
``B`` (a bitmap ``Matrix``) makes the sparse product k times as useful
per random access as SpMV.  ``mxm`` takes this engine when ``A`` is CSR
or CSC and ``B`` is a bitmap ``Matrix`` (``ops/mxm.py``).

Engine: **bucketed ELL**, as in the JAX package.  At plan time (host,
cached on the matrix) the rows are grouped into power-of-two length
buckets and the entries permuted into bucket-major slot order, padded
slots pointing at a sentinel.  Per call: one gather of X's rows at the
slot columns, one multiply by the slot values, one dense reduction per
bucket (reshape (rows, L, k) and reduce over L with the add monoid) and
one scatter of the bucket rows into place.  Absent X entries and padded
slots contribute the add identity; the output pattern is the rows with
at least one live contribution per column.

The bucket reduction is the add monoid's own ``Monoid.reduce`` in place
of the JAX package's ``_axis_reduce``: the function the bitmap engines
reduce with, so float MIN/MAX ignore NaN and unsigned types reduce in
their own order (``_axis_reduce`` calls ``jnp.min``/``jnp.max``, which
propagate NaN).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.semirings import Semiring
from ..core.types import Type, cast
from ..ops.flopcount import record_axb_method
from .container import CsrMatrix
from .spmv import _mult_apply

__all__ = ["csr_spmm_dense", "spmm_plan", "SpmmPlan"]


class SpmmPlan(NamedTuple):
    """Bucketed-ELL slot layout: ``perm`` gathers A's entries into
    bucket-major slots (sentinel ``nzmax``: a padded slot), ``cols_slot``
    their columns (sentinel ``ncols``), ``rowids`` the bucket rows in
    slot order (device tensors); ``buckets`` a tuple of (offset, rows,
    L) on the host."""
    cols_slot: torch.Tensor
    perm: torch.Tensor
    rowids: torch.Tensor
    buckets: tuple
    nslots: int


def _host_csr(A: CsrMatrix):
    """(row degrees, column indices in CSR order) on the host: from the
    build-time host pattern when it is there."""
    hp = A._options.get("host_pattern")
    if hp is not None:
        rows, cols = np.asarray(hp[0][:A.nvals]), np.asarray(hp[1])
        return np.bincount(rows, minlength=A.nrows).astype(np.int64), cols
    ip = A.indptr.cpu().numpy().astype(np.int64)
    return np.diff(ip), A.indices.cpu().numpy()


def spmm_plan(A: CsrMatrix) -> SpmmPlan:
    """The bucketed-ELL plan of ``A``, built on the host once and cached
    on the container."""
    plan = A._options.get("_spmm_plan")
    if plan is not None:
        return plan
    deg, cols = _host_csr(A)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    rows_live = np.nonzero(deg > 0)[0]
    # power-of-two bucket per live row
    L = np.ones_like(deg)
    np.maximum(L, 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(int),
               out=L)
    order = np.argsort(L[rows_live], kind="stable")
    rows_b = rows_live[order]
    Lb = L[rows_b]
    nslots = int(Lb.sum())
    perm = np.full(nslots, A.nzmax, np.int64)       # sentinel: padded
    cols_slot = np.full(nslots, A.ncols, np.int64)
    offs = np.concatenate([[0], np.cumsum(Lb)])
    # entry e of row r lands at offs[rank(r)] + (e - indptr[r])
    nnz = int(deg.sum())
    if nnz:
        rnk = np.zeros(len(deg), np.int64)
        rnk[rows_b] = np.arange(len(rows_b))
        row_of_e = np.repeat(np.arange(len(deg)), deg)
        e = np.arange(nnz, dtype=np.int64)
        slot_of_e = offs[rnk[row_of_e]] + (e - indptr[row_of_e])
        perm[slot_of_e] = e
        cols_slot[slot_of_e] = cols[:nnz]
    # bucket table: the runs of equal L
    starts = np.nonzero(np.diff(Lb, prepend=-1))[0]
    ends = np.append(starts[1:], len(Lb))
    buckets = tuple((int(offs[s]), int(e - s), int(Lb[s]))
                    for s, e in zip(starts, ends))
    dev = A.device
    plan = SpmmPlan(torch.from_numpy(cols_slot).to(dev),
                    torch.from_numpy(perm).to(dev),
                    torch.from_numpy(rows_b.astype(np.int64)).to(dev),
                    buckets, nslots)
    A._options["_spmm_plan"] = plan
    return plan


def csr_spmm_dense(sr: Semiring, A: CsrMatrix, Xvals: torch.Tensor,
                   Xpat: Optional[torch.Tensor] = None,
                   x_type: Optional[Type] = None):
    """(yvals, ypat) = A *.sr* X through the bucketed-ELL engine.
    ``Xvals`` is the [ncols, k] value tensor of type ``x_type`` (default:
    the type its dtype names); ``Xpat`` an optional same-shape bool
    presence mask (None: every entry present).  Absent X entries
    contribute the add identity; the output pattern is the rows with at
    least one live contribution, per column."""
    if any(t.is_udt for t in (sr.ztype, sr.xtype, sr.ytype, A.type)):
        raise TypeError("the SpMM engine takes builtin types; mxm runs a "
                        "user-defined semiring on the bitmap product")
    plan = spmm_plan(A)
    zt = sr.ztype
    dev = A.device
    k = Xvals.shape[1]
    X = cast(Xvals.to(dev), sr.ytype, x_type)
    Xe = torch.cat([X, torch.zeros((1, k), dtype=X.dtype, device=dev)])
    avals = cast(A.values, sr.xtype, A.type)
    avals_ext = torch.cat([avals, torch.zeros(1, dtype=avals.dtype,
                                              device=dev)])
    va = avals_ext[plan.perm]                            # slot values
    Xg = Xe[plan.cols_slot]                              # (S, k) gather
    z = _mult_apply(sr, va[:, None], Xg).expand(Xg.shape).to(zt.storage)
    dead = (plan.cols_slot >= A.ncols)[:, None]
    if Xpat is not None:
        Xpe = torch.cat([Xpat.to(dev, torch.bool),
                         torch.zeros((1, k), dtype=torch.bool, device=dev)])
        dead = dead | ~Xpe[plan.cols_slot]
    z = torch.where(dead, sr.add.identity_array((), dev), z)
    outs, pats = [], []
    for off, cnt, L in plan.buckets:
        outs.append(sr.add.reduce(z[off:off + cnt * L].reshape(cnt, L, k),
                                  axis=1))
        if Xpat is not None:
            pats.append((~dead[off:off + cnt * L]).reshape(cnt, L, k)
                        .any(dim=1))
    # the bucket rows are rowids, in bucket order
    y = torch.zeros((A.nrows, k), dtype=zt.storage, device=dev)
    ypat = torch.zeros((A.nrows, k), dtype=torch.bool, device=dev)
    if outs:
        ypat[plan.rowids] = True if Xpat is None else torch.cat(pats)
        y[plan.rowids] = torch.cat(outs)
        y = torch.where(ypat, y, torch.zeros((), dtype=zt.storage,
                                             device=dev))
    record_axb_method("spmm:ell")
    return y, ypat
