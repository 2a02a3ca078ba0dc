"""Padded-CSR sparse container on torch tensors.

Counterpart of ``graphblas_tpu/sparse/container.py`` with the same
layout, so the two packages' arrays compare one to one: CSR arrays plus
the COO row-ids dual (``rowids``), padded to a capacity ``nzmax``.
Padding convention: ``indices[k >= nvals] == ncols`` and
``rowids[k >= nvals] == nrows`` (out-of-range sentinels), ``values`` 0.

The host pattern of a container built from tuples is kept in
``_options["host_pattern"]`` as numpy ``(rowids, indices)``: the
planners read it instead of copying the device arrays back.

The default device is the CUDA card: a constructor called without
``device`` on a machine with no card raises (pass ``device="cpu"`` to
work on the CPU); helpers that make tensors from a container's take its
device.  ``CscMatrix`` is the by-column twin (the stored transpose).

Over a user-defined type ``values`` is a dict of padded tensors, one per
field (:mod:`graphblas_tpu_torch.core.types`), sorted and padded in
lockstep with the keys; ``csr_from_coo`` over such a type rejects
duplicate tuples, since no dup operator folds structs by default (the
JAX package's ``_csr_from_coo_udt``).

Element mutation is functional, as in the JAX package: ``setElement``
returns a new container with one more pending tuple (host-side, no
device work), ``wait`` folds them (:mod:`.pending`), and every read of
the stored arrays (``extractTuples``, ``to_matrix``, ``T``, the
operations) folds first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.errors import IndexOutOfBounds
from ..core.matrix import Matrix, as_pending, device_values, host_values
from ..core.types import Type, type_of_dtype
from ..utils import faultinject
from ..utils.tree import tree_map
from ..io.native import sort_dedup_native, sort_pairs_native

__all__ = ["CsrMatrix", "CscMatrix", "csr_from_coo", "default_device",
           "resolve_device"]


def default_device() -> torch.device:
    """The library's default device: the CUDA card."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`,
    which must exist: without a card this raises rather than carry on
    on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: graphblas_tpu_torch runs on the card by "
            "default; pass device=\"cpu\" to work on the CPU")
    return default_device()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class CsrMatrix:
    """Padded CSR: indptr[m+1], indices[nzmax], rowids[nzmax] (int32),
    values[nzmax] in the type's storage dtype."""

    __slots__ = ("indptr", "indices", "rowids", "values", "nvals",
                 "nrows", "ncols", "type", "_options", "_pending")

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 rowids: torch.Tensor, values: torch.Tensor, nvals: int,
                 nrows: int, ncols: int, type: Type, pending=None):
        self.indptr = indptr
        self.indices = indices
        self.rowids = rowids
        self.values = values
        self.nvals = int(nvals)
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.type = type
        self._options = {}
        # the non-blocking delta list: (i, j, scalar, accum op)
        # (reference GB_pending_add / GB_matrix.h:249-315)
        self._pending = as_pending(pending)

    def _shallow(self) -> "CsrMatrix":
        out = CsrMatrix(self.indptr, self.indices, self.rowids,
                        self.values, self.nvals, self.nrows, self.ncols,
                        self.type, pending=self._pending)
        out._options = dict(self._options)
        return out

    # -- pending tuples / element mutation (GB_setElement + GB_wait) ------
    def wait(self) -> "CsrMatrix":
        """Fold the pending delta list (reference ``GB_wait``)."""
        if not self._pending:
            return self
        from .pending import fold_pending_csr
        return fold_pending_csr(self)

    def setElement(self, value, i: int, j: int, *, accum=None,
                   blocking=None) -> "CsrMatrix":
        """Functional setElement -> pending tuple (``GB_setElement.c``)."""
        from .pending import append_pending
        return append_pending(self, i, j, value, accum, blocking)

    def extractElement(self, i: int, j: int):
        """The value at (i, j) as a numpy scalar, or None for
        GrB_NO_VALUE (``GB_extractElement.c``): a binary search within
        row i, which alone crosses to the host."""
        from .pending import check_index
        check_index(self, i, j)
        A = self.wait()
        s, e = (int(x) for x in A.indptr[i:i + 2].cpu())
        if s == e:
            return None
        row = A.indices[s:e].cpu().numpy()
        pos = int(np.searchsorted(row, j))
        if pos >= len(row) or row[pos] != j:
            return None
        x = host_values(tree_map(lambda v: v[s + pos:s + pos + 1],
                                 A.values), A.type)
        return tree_map(lambda a: a[0], x)

    def removeElement(self, i: int, j: int) -> "CsrMatrix":
        """Delete one entry — the functional form of a zombie +
        immediate ``GB_wait`` (``GB_FLIP``, GB.h:2513-2543)."""
        from .pending import check_index
        from .tri import csr_filter_lanes
        check_index(self, i, j)
        A = self.wait()
        keep = ~((A.rowids == i) & (A.indices == j))
        return csr_filter_lanes(A, keep)

    def resize(self, nrows_new: int, ncols_new: int) -> "CsrMatrix":
        """GxB_Matrix_resize: prune outside entries, remap on device."""
        from .pending import csr_resize
        return csr_resize(self, nrows_new, ncols_new)

    def clear(self) -> "CsrMatrix":
        from .mask import csr_clear
        return csr_clear(self)

    def row_degrees(self) -> torch.Tensor:
        """Entries per row (int32, on the device)."""
        return self.indptr[1:] - self.indptr[:-1]

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nzmax(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, nzmax: Optional[int] = None,
                 sum_duplicates: bool = True,
                 device=None) -> "CsrMatrix":
        return csr_from_coo(I, J, X, nrows, ncols, type=type, nzmax=nzmax,
                            sum_duplicates=sum_duplicates, device=device)

    def extractTuples(self):
        """(I, J, X) of the live entries as host arrays, X in the type's
        numpy dtype (pending tuples folded first)."""
        A = self.wait()
        X = host_values(tree_map(lambda v: v[:A.nvals], A.values), A.type)
        return (A.rowids[:A.nvals].cpu().numpy().astype(np.int64),
                A.indices[:A.nvals].cpu().numpy().astype(np.int64),
                X)

    @staticmethod
    def from_matrix(A: Matrix, nzmax: Optional[int] = None) -> "CsrMatrix":
        """Bitmap Matrix -> padded CSR on the Matrix's device (host-side
        O(nnz) conversion, as the JAX package's)."""
        I, J, X = A.extractTuples()
        return csr_from_coo(I, J, X, A.nrows, A.ncols, type=A.type,
                            nzmax=nzmax, sum_duplicates=False,
                            device=A.device)

    def to_matrix(self) -> Matrix:
        """Padded CSR -> bitmap Matrix on the same device."""
        self = self.wait()
        m, n = self.shape
        dev = self.device
        lin = (self.rowids[:self.nvals].long() * n
               + self.indices[:self.nvals].long())

        def scat(v):
            out = torch.zeros(m * n, dtype=v.dtype, device=dev)
            out[lin] = v[:self.nvals]
            return out.reshape(m, n)
        pat = torch.zeros(m * n, dtype=torch.bool, device=dev)
        pat[lin] = True
        return Matrix(tree_map(scat, self.values), pat.reshape(m, n),
                      self.type)

    def T(self) -> "CsrMatrix":
        """Transpose = re-sorted COO (host side, a counting sort in the
        reference's ``GB_transpose_bucket.c``)."""
        A = self.wait()
        I, J, X = A.extractTuples()
        return csr_from_coo(J, I, X, A.ncols, A.nrows, type=A.type,
                            nzmax=A.nzmax, sum_duplicates=False,
                            device=A.device)

    def __repr__(self):  # pragma: no cover
        return (f"CsrMatrix<{self.type.name}> {self.nrows}x{self.ncols}, "
                f"{self.nvals}/{self.nzmax} entries on {self.device}"
                + (f", {len(self._pending)} pending" if self._pending
                   else ""))


class CscMatrix:
    """By-column twin of :class:`CsrMatrix` (the reference's
    ``GxB_BY_COL`` format, ``GB_matrix.h:394`` ``is_csc``): it stores the
    transpose's padded-CSR arrays in ``tr``, so ``T()`` is free and
    ``vxm`` (u'A) runs on the stored arrays with no conversion; the
    row-oriented ops convert through :meth:`to_csr` (one resort)."""

    __slots__ = ("tr", "_options")

    def __init__(self, tr: CsrMatrix):
        self.tr = tr
        self._options = {"format": "by_col"}

    @property
    def nrows(self) -> int:
        return self.tr.ncols

    @property
    def ncols(self) -> int:
        return self.tr.nrows

    @property
    def shape(self):
        return (self.tr.ncols, self.tr.nrows)

    @property
    def nvals(self) -> int:
        return self.tr.nvals

    @property
    def nzmax(self) -> int:
        return self.tr.nzmax

    @property
    def type(self) -> Type:
        return self.tr.type

    @property
    def device(self) -> torch.device:
        return self.tr.device

    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, nzmax: Optional[int] = None,
                 sum_duplicates: bool = True, device=None) -> "CscMatrix":
        return CscMatrix(csr_from_coo(J, I, X, ncols, nrows, type=type,
                                      nzmax=nzmax,
                                      sum_duplicates=sum_duplicates,
                                      device=device))

    @staticmethod
    def from_csr(A: CsrMatrix) -> "CscMatrix":
        """CSR -> CSC (one transpose resort)."""
        return CscMatrix(A.T())

    def to_csr(self) -> CsrMatrix:
        return self.tr.T()

    def T(self) -> CsrMatrix:
        """Transpose, free: A' in CSR is exactly the stored arrays."""
        return self.tr

    def to_matrix(self) -> Matrix:
        M = self.tr.to_matrix()
        return Matrix(tree_map(lambda v: v.T.contiguous(), M.values),
                      M.pattern.T.contiguous(), self.type)

    def extractTuples(self):
        """(I, J, X) in column order (the CSC storage order)."""
        J, I, X = self.tr.extractTuples()
        return I, J, X

    #: CSC component views (the reference's export names)
    @property
    def colptr(self) -> torch.Tensor:
        return self.tr.indptr

    @property
    def rowidx(self) -> torch.Tensor:
        return self.tr.indices

    @property
    def values(self) -> torch.Tensor:
        return self.tr.values

    def col_degrees(self) -> torch.Tensor:
        """Entries per column (int32, on the device)."""
        return self.tr.row_degrees()

    # -- pending tuples / element mutation (the stored transpose's, with
    #    the coordinates swapped) -------------------------------------------
    def wait(self) -> "CscMatrix":
        t = self.tr.wait()
        return self if t is self.tr else CscMatrix(t)

    def setElement(self, value, i: int, j: int, *, accum=None,
                   blocking=None) -> "CscMatrix":
        return CscMatrix(self.tr.setElement(value, j, i, accum=accum,
                                            blocking=blocking))

    def extractElement(self, i: int, j: int):
        return self.tr.extractElement(j, i)

    def removeElement(self, i: int, j: int) -> "CscMatrix":
        return CscMatrix(self.tr.removeElement(j, i))

    def resize(self, nrows_new: int, ncols_new: int) -> "CscMatrix":
        return CscMatrix(self.tr.resize(ncols_new, nrows_new))

    def clear(self) -> "CscMatrix":
        return CscMatrix(self.tr.clear())

    def __repr__(self):  # pragma: no cover
        return (f"CscMatrix<{self.type.name}> {self.nrows}x{self.ncols}, "
                f"{self.nvals}/{self.nzmax} entries (by_col) on "
                f"{self.device}")


def _sort_tuples(I, J, X, nrows: int, ncols: int, sum_duplicates: bool):
    """Lexsort (i, j), folding duplicates with PLUS when asked (the
    native radix sort when available, numpy otherwise)."""
    if sum_duplicates and X.dtype == np.float64:
        nat = sort_dedup_native(I, J, X, "PLUS")
        if nat is not None:
            return nat
    sp = sort_pairs_native(I, J, nrows, ncols)
    if sp is not None:
        I, J, perm = sp
        X = X[perm]
    else:
        order = np.lexsort((J, I))
        I, J, X = I[order], J[order], X[order]
    if sum_duplicates:
        lin = I * ncols + J
        first = np.ones(len(lin), bool)
        first[1:] = lin[1:] != lin[:-1]
        starts = np.nonzero(first)[0]
        X = np.add.reduceat(X, starts) if len(starts) < len(X) else X
        I, J = I[starts], J[starts]
    return I, J, X


def csr_from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, nzmax: Optional[int] = None,
                 sum_duplicates: bool = True, device=None) -> CsrMatrix:
    """Host-side CSR build: lexsort (i, j), optional dup-sum, pad to
    capacity, move to ``device`` (see :func:`resolve_device`)."""
    faultinject.checkpoint("csr_from_coo")
    device = resolve_device(device)
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    if type is not None and type.is_udt:
        return _csr_from_coo_udt(I, J, X, nrows, ncols, type, nzmax,
                                 sum_duplicates, device)
    X = np.asarray(X)
    t = type or type_of_dtype(X.dtype)
    if I.size:
        # a negative or out-of-range index would silently corrupt the
        # CSR (and the native radix sort assumes non-negative keys)
        imin, imax = I.min(), I.max()
        jmin, jmax = J.min(), J.max()
        if imin < 0 or imax >= nrows or jmin < 0 or jmax >= ncols:
            raise IndexOutOfBounds(
                f"tuple index out of range for {nrows}x{ncols}: "
                f"rows [{imin},{imax}], cols [{jmin},{jmax}]")
        I, J, X = _sort_tuples(I, J, X, nrows, ncols, sum_duplicates)
    nvals = len(I)
    cap = nzmax or _round_up(max(nvals, 8), 128)
    if cap < nvals:
        raise ValueError(f"nzmax {cap} < nvals {nvals}")
    indptr = np.zeros(nrows + 1, np.int32)
    np.add.at(indptr, I + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.full(cap, ncols, np.int32)
    rowids = np.full(cap, nrows, np.int32)
    values = np.zeros(cap, t.dtype)
    indices[:nvals] = J
    rowids[:nvals] = I
    values[:nvals] = X.astype(t.dtype, copy=False)

    def dev(a):
        return torch.from_numpy(a).to(device)

    A = CsrMatrix(dev(indptr), dev(indices), dev(rowids),
                  dev(t.to_storage(values)), nvals, nrows, ncols, t)
    A._options["host_pattern"] = (rowids, indices)
    return A


def _udt_host(X, t: Type):
    """A struct value's field arrays as host arrays of the fields'
    dtypes (tensors copied back)."""
    if not isinstance(X, dict):
        raise TypeError(f"values of the user-defined type {t.name} must be "
                        f"a dict of field arrays")
    return {k: _udt_host(X[k], ft) if ft.is_udt else np.asarray(
        X[k].cpu() if isinstance(X[k], torch.Tensor) else X[k]).astype(
            ft.dtype, copy=False) for k, ft in t.fields}


def _csr_from_coo_udt(I, J, X, nrows: int, ncols: int, t: Type,
                      nzmax: Optional[int], sum_duplicates: bool,
                      device) -> CsrMatrix:
    """The build over a user-defined type: every field sorted and padded
    in lockstep with the (i, j) keys.  With ``sum_duplicates`` a repeated
    tuple raises ``TypeError``: no default dup op folds structs (the
    reference requires an explicit dup op, ``GB_build.c``)."""
    if I.size:
        imin, imax = I.min(), I.max()
        jmin, jmax = J.min(), J.max()
        if imin < 0 or imax >= nrows or jmin < 0 or jmax >= ncols:
            raise IndexOutOfBounds(
                f"tuple index out of range for {nrows}x{ncols}: "
                f"rows [{imin},{imax}], cols [{jmin},{jmax}]")
    X = _udt_host(X, t)
    if I.size:
        order = np.lexsort((J, I))
        I, J = I[order], J[order]
        X = tree_map(lambda a: a[order], X)
        lin = I * ncols + J
        if sum_duplicates and I.size > 1 and np.any(lin[1:] == lin[:-1]):
            raise TypeError("struct (user-defined) tuples must be "
                            "duplicate-free: no default dup op folds them")
    nvals = len(I)
    cap = nzmax or _round_up(max(nvals, 8), 128)
    if cap < nvals:
        raise ValueError(f"nzmax {cap} < nvals {nvals}")
    indptr = np.zeros(nrows + 1, np.int32)
    np.add.at(indptr, I + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.full(cap, ncols, np.int32)
    rowids = np.full(cap, nrows, np.int32)
    indices[:nvals] = J
    rowids[:nvals] = I
    vals = tree_map(lambda v: torch.cat([v, v.new_zeros(cap - nvals)]),
                    device_values(X, t, device))

    def dev(a):
        return torch.from_numpy(a).to(device)

    A = CsrMatrix(dev(indptr), dev(indices), dev(rowids), vals, nvals,
                  nrows, ncols, t)
    A._options["host_pattern"] = (rowids, indices)
    return A
