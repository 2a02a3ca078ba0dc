"""By-column hypersparse container, the fourth storage format.

Counterpart of ``graphblas_tpu/sparse/hyper_csc.py``.  The reference
stores all four orientations natively (CSR / CSC / hyper-CSR /
hyper-CSC, ``Source/Template/GB_matrix.h:41-132``, ``is_csc`` x
``is_hyper``).  :class:`HyperCscMatrix` completes the square as
:class:`~.container.CscMatrix` does for CSR: it stores the TRANSPOSE as
a by-row :class:`~.hyper.HyperMatrix`, so

* ``.T()`` is free (the wrapped HyperMatrix),
* by-row conversion costs one pair re-sort (``to_hyper()``), the
  explicit transpose the reference pays when formats disagree
  (``GB_AxB_meta.c:199-355``),
* the dimension is unbounded like the wrapped container's (2^60).

The operations take it as an input wherever ``to_hyper_operand`` is
used (the orientation folds into the transpose flag) and produce it as
an output in the transposed frame: ``C<M> = accum(C, T)`` by column is
``C'<M'> = accum(C', T')`` on the wrapped by-row container.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import Type
from .hyper import HyperMatrix, hyper_from_coo, hyper_transpose

__all__ = ["HyperCscMatrix"]


class HyperCscMatrix:
    """By-column doubly-compressed matrix (GxB_BY_COL + hypersparse)."""

    __slots__ = ("tr", "_options")

    def __init__(self, tr: HyperMatrix):
        self.tr = tr
        self._options = {"format": "by_col"}

    # -- metadata mirrors ---------------------------------------------------
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
    def nvec(self) -> int:
        """Number of non-empty COLUMNS (the by-column hyper list)."""
        return self.tr.nvec

    @property
    def device(self) -> torch.device:
        return self.tr.device

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, dup="plus",
                 device=None) -> "HyperCscMatrix":
        return HyperCscMatrix(hyper_from_coo(J, I, X, ncols, nrows,
                                             type=type, dup=dup,
                                             device=device))

    @staticmethod
    def from_hyper(A: HyperMatrix) -> "HyperCscMatrix":
        """By-row -> by-column (one pair re-sort)."""
        return HyperCscMatrix(hyper_transpose(A))

    # -- conversions --------------------------------------------------------
    def to_hyper(self) -> HyperMatrix:
        """By-column -> by-row (one pair re-sort)."""
        return hyper_transpose(self.tr)

    def T(self) -> HyperMatrix:
        """Transpose, free: A' by row is exactly the stored container."""
        return self.tr

    def extractTuples(self):
        """(I, J, X) in column-major order (the CSC storage order)."""
        J, I, X = self.tr.extractTuples()
        return I, J, X

    # -- pending tuples / element mutation (delegated, coords swapped) ------
    def wait(self) -> "HyperCscMatrix":
        t = self.tr.wait()
        return self if t is self.tr else HyperCscMatrix(t)

    def setElement(self, value, i, j, *, accum=None,
                   blocking=None) -> "HyperCscMatrix":
        return HyperCscMatrix(self.tr.setElement(value, j, i, accum=accum,
                                                 blocking=blocking))

    def extractElement(self, i, j):
        return self.tr.extractElement(j, i)

    def removeElement(self, i, j) -> "HyperCscMatrix":
        return HyperCscMatrix(self.tr.removeElement(j, i))

    def resize(self, nrows_new: int, ncols_new: int) -> "HyperCscMatrix":
        return HyperCscMatrix(self.tr.resize(ncols_new, nrows_new))

    def clear(self) -> "HyperCscMatrix":
        return HyperCscMatrix(self.tr.clear())

    def __repr__(self):  # pragma: no cover
        return (f"HyperCscMatrix<{self.type.name}> "
                f"{self.nrows}x{self.ncols}, {self.nvals} entries, "
                f"{self.nvec} non-empty cols (by_col hyper)")
