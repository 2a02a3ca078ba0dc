"""Import / export: the hand-off of raw sparse arrays.

Counterpart of ``graphblas_tpu/core/io_export.py``.  Reference:
``GxB_Matrix_import_CSR/CSC/HyperCSR/HyperCSC`` and the matching
exports, O(1) moves of user arrays (``GxB_Matrix_import_CSR.c:50-80``).
The containers are plain arrays, so import/export is a constructor /
deconstructor pair: CSR arrays land on a :class:`CsrMatrix` on
``device`` (the card unless the caller passes one), exports return host
numpy arrays.  A hypersparse import becomes a ``HyperMatrix`` when the
dimension is too large for an O(nrows) indptr; otherwise it becomes a
CSR container and conforms by the ``hyper_ratio`` rule
(``hyper_conform``), so a mostly empty row space stays hypersparse.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .matrix import Vector
from .types import FP64, Type

__all__ = ["import_csr", "import_csc", "import_hyper_csr",
           "import_hyper_csc", "export_csr", "export_csc",
           "export_hyper_csr", "export_hyper_csc", "import_vector",
           "export_vector"]


def _host_values(X: torch.Tensor, t: Type) -> np.ndarray:
    x = X.cpu().numpy()
    return x.view(t.dtype) if t.is_unsigned else x


def import_csr(nrows: int, ncols: int, indptr, indices, values,
               type: Optional[Type] = None, jumbled: bool = False,
               device=None):
    """CSR arrays -> CsrMatrix (``GxB_Matrix_import_CSR``): the arrays
    are padded to the container's capacity and moved to ``device``;
    ``jumbled`` rows are sorted first."""
    from ..sparse.container import CsrMatrix, csr_from_coo, resolve_device
    device = resolve_device(device)
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    values = np.asarray(values)
    t = type or FP64
    nvals = int(indptr[-1])
    rowids = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
    if jumbled:
        return csr_from_coo(rowids, indices[:nvals], values[:nvals],
                            nrows, ncols, type=t, sum_duplicates=False,
                            device=device)
    cap = max(((nvals + 127) // 128) * 128, 128)
    ind = np.full(cap, ncols, np.int32)
    rid = np.full(cap, nrows, np.int32)
    val = np.zeros(cap, t.dtype)
    ind[:nvals] = indices[:nvals]
    rid[:nvals] = rowids
    val[:nvals] = values[:nvals]

    def dev(a):
        return torch.from_numpy(a).to(device)
    return CsrMatrix(dev(indptr.astype(np.int32)), dev(ind), dev(rid),
                     dev(t.to_storage(val)), nvals, nrows, ncols, t)


def import_csc(nrows: int, ncols: int, indptr, indices, values,
               type: Optional[Type] = None, device=None):
    """CSC arrays -> CscMatrix (``GxB_Matrix_import_CSC``): the arrays
    land unchanged as the by-column container's storage."""
    from ..sparse.container import CscMatrix
    return CscMatrix(import_csr(ncols, nrows, indptr, indices, values,
                                type, device=device))


def import_hyper_csr(nrows: int, ncols: int, nvec: int, h, p, indices,
                     values, type: Optional[Type] = None, device=None):
    """Hypersparse CSR (h = present rows, p = their pointer list) ->
    HyperMatrix when the dimension is too large for an O(nrows) indptr
    (``GxB_Matrix_import_HyperCSR``; dimension up to 2^60,
    ``GB.h:314-323``), else a CsrMatrix conformed by the ``hyper_ratio``
    rule."""
    h = np.asarray(h, np.int64)[:nvec]
    p = np.asarray(p, np.int64)[:nvec + 1]
    counts = np.diff(p)
    if nrows > (1 << 28) or ncols > (1 << 31):
        from ..sparse.hyper import hyper_from_coo
        I = np.repeat(h, counts)
        nnz = int(p[-1]) if len(p) else 0
        return hyper_from_coo(I, np.asarray(indices, np.int64)[:nnz],
                              np.asarray(values)[:nnz], nrows, ncols,
                              type=type, dup=None, device=device)
    indptr = np.zeros(nrows + 1, np.int64)
    indptr[h + 1] = counts
    indptr = np.cumsum(indptr)
    out = import_csr(nrows, ncols, indptr, indices, values, type,
                     device=device)
    # GB_to_hyper_conform: a mostly empty row space stays hypersparse
    from ..sparse.hyper import hyper_conform
    return hyper_conform(out)


def import_hyper_csc(nrows: int, ncols: int, nvec: int, h, p, indices,
                     values, type: Optional[Type] = None, device=None):
    """Hypersparse CSC (h = present COLUMNS, p = their pointer list,
    indices = row ids per column) -> HyperCscMatrix
    (``GxB_Matrix_import_HyperCSC``): the arrays are the wrapped
    transpose's by-row hypersparse form."""
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    tr = import_hyper_csr(ncols, nrows, nvec, h, p, indices, values,
                          type=type, device=device)
    if not isinstance(tr, HyperMatrix):
        tr = HyperMatrix.from_csr(tr)
    return HyperCscMatrix(tr)


def export_csr(A) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Matrix / CsrMatrix -> (nrows, ncols, indptr, indices, values) as
    host arrays (``GxB_Matrix_export_CSR``); the CSR arrays as stored,
    any other container through its tuples."""
    from ..sparse.container import CsrMatrix
    if isinstance(A, CsrMatrix):
        A = A.wait()
        n = A.nvals
        return (A.nrows, A.ncols, A.indptr.cpu().numpy().astype(np.int64),
                A.indices[:n].cpu().numpy().astype(np.int64),
                _host_values(A.values[:n], A.type))
    I, J, X = A.extractTuples()
    indptr = np.zeros(A.nrows + 1, np.int64)
    np.add.at(indptr, I + 1, 1)
    return A.nrows, A.ncols, np.cumsum(indptr), J, X


def export_hyper_csr(A):
    """Container -> (nrows, ncols, nvec, h, p, indices, values) in
    hypersparse-CSR form: ``h`` lists the nonempty rows, ``p`` their
    compacted pointer list (``GxB_Matrix_export_HyperCSR``), the O(nvec)
    dual of :func:`import_hyper_csr`."""
    from ..sparse.hyper import HyperMatrix
    if isinstance(A, HyperMatrix):
        # the container stores h/hptr already
        A = A.wait()
        n = A.nvals
        return (A.nrows, A.ncols, A.nvec,
                A.h[:A.nvec].cpu().numpy(),
                A.hptr[:A.nvec + 1].cpu().numpy().astype(np.int64),
                A.indices[:n].cpu().numpy(),
                _host_values(A.values[:n], A.type))
    nrows, ncols, indptr, indices, values = export_csr(A)
    counts = np.diff(indptr)
    h = np.nonzero(counts)[0].astype(np.int64)
    p = np.concatenate([[0], np.cumsum(counts[h])]).astype(np.int64)
    return nrows, ncols, len(h), h, p, indices, values


def export_csc(A):
    """(nrows, ncols, col indptr, row indices, values) in CSC order: a
    CscMatrix exports its stored arrays, any other container re-sorts
    its tuples (never through a dense intermediate)."""
    from ..sparse.container import CscMatrix
    if isinstance(A, CscMatrix):
        ncols, nrows, indptr, idx, vals = export_csr(A.tr)
        return nrows, ncols, indptr, idx, vals
    I, J, X = A.extractTuples()
    order = np.lexsort((I, J))
    I, J, X = I[order], J[order], X[order]
    indptr = np.zeros(A.ncols + 1, np.int64)
    np.add.at(indptr, J + 1, 1)
    return A.nrows, A.ncols, np.cumsum(indptr), I, X


def export_hyper_csc(A):
    """Container -> (nrows, ncols, nvec, h, p, indices, values) in
    hypersparse-CSC form (``GxB_Matrix_export_HyperCSC``): ``h`` lists
    the nonempty columns, ``indices`` the row ids per column.  A
    HyperCscMatrix exports its wrapped transpose as it is."""
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(A, HyperCscMatrix):
        ncols, nrows, nvec, h, p, idx, vals = export_hyper_csr(A.tr)
        return nrows, ncols, nvec, h, p, idx, vals
    from ..ops.containers import to_hyper_operand
    At = to_hyper_operand(A, True, "export")
    ncols, nrows, nvec, h, p, idx, vals = export_hyper_csr(At)
    return nrows, ncols, nvec, h, p, idx, vals


def import_vector(n: int, indices, values, type: Optional[Type] = None,
                  device=None) -> Vector:
    """Sparse vector import (``GxB_Vector_import``) into a bitmap
    Vector."""
    return Vector.from_coo(np.asarray(indices, np.int64),
                           np.asarray(values), n, type=type or FP64,
                           device=device)


def export_vector(v: Vector):
    I, X = v.extractTuples()
    return v.size, I, X
