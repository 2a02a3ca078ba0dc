"""Padded-CSR sparse container on torch tensors.

Counterpart of ``graphblas_tpu/sparse/container.py`` with the same
layout, so the two packages' arrays compare one to one: CSR arrays plus
the COO row-ids dual (``rowids``), padded to a capacity ``nzmax``.
Padding convention: ``indices[k >= nvals] == ncols`` and
``rowids[k >= nvals] == nrows`` (out-of-range sentinels), ``values`` 0.

The host pattern of a container built from tuples is kept in
``_options["host_pattern"]`` as numpy ``(rowids, indices)``: the
planners read it instead of copying the device arrays back.

Pending tuples, ``CscMatrix`` and ``to_matrix`` come with the containers
slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.errors import IndexOutOfBounds
from ..core.types import Type, type_of_dtype
from ..io.native import sort_dedup_native, sort_pairs_native

__all__ = ["CsrMatrix", "csr_from_coo", "default_device"]


def default_device() -> torch.device:
    """The library's default device: CUDA when present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class CsrMatrix:
    """Padded CSR: indptr[m+1], indices[nzmax], rowids[nzmax] (int32),
    values[nzmax] in the type's storage dtype."""

    __slots__ = ("indptr", "indices", "rowids", "values", "nvals",
                 "nrows", "ncols", "type", "_options")

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 rowids: torch.Tensor, values: torch.Tensor, nvals: int,
                 nrows: int, ncols: int, type: Type):
        self.indptr = indptr
        self.indices = indices
        self.rowids = rowids
        self.values = values
        self.nvals = int(nvals)
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.type = type
        self._options = {}

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
        numpy dtype."""
        X = self.values[:self.nvals].cpu().numpy()
        if self.type.is_unsigned:
            X = X.view(self.type.dtype)
        return (self.rowids[:self.nvals].cpu().numpy().astype(np.int64),
                self.indices[:self.nvals].cpu().numpy().astype(np.int64),
                X)

    def T(self) -> "CsrMatrix":
        """Transpose = re-sorted COO (host side, a counting sort in the
        reference's ``GB_transpose_bucket.c``)."""
        I, J, X = self.extractTuples()
        return csr_from_coo(J, I, X, self.ncols, self.nrows,
                            type=self.type, nzmax=self.nzmax,
                            sum_duplicates=False, device=self.device)

    def __repr__(self):  # pragma: no cover
        return (f"CsrMatrix<{self.type.name}> {self.nrows}x{self.ncols}, "
                f"{self.nvals}/{self.nzmax} entries on {self.device}")


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
    capacity, move to ``device`` (default: :func:`default_device`)."""
    device = default_device() if device is None else torch.device(device)
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
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
