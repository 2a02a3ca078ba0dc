"""SparseVec: a first-class sparse vector at any dimension.

Counterpart of ``graphblas_tpu/sparse/vector.py``.  The reference has
no separate vector implementation: a ``GrB_Vector`` is a vlen x 1
non-hyper CSC matrix (``Source/Template/GB_matrix.h:18-26``) and every
vector operation forwards to the matrix kernels.  A SparseVec does the
same against the hypersparse engine: it wraps a vlen x 1
:class:`~.hyper.HyperMatrix`, so merges, the accum/mask epilogue,
assign/extract, reduce, apply/select, element mutation with pending
tuples and SpMV (a one-column SpGEMM) all come from the pair-key
machinery that runs at dimension 2^60.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.types import Type, zeros_like_typed
from ..utils.tree import tree_map
from .hyper import HyperMatrix, hyper_from_coo

__all__ = ["SparseVec"]

#: largest size a SparseVec densifies to a bitmap Vector
_DENSIFY_CAP = 1 << 26


class SparseVec:
    """Immutable sparse vector = vlen x 1 hypersparse column."""

    __slots__ = ("hm",)

    def __init__(self, hm: HyperMatrix):
        if hm.ncols != 1:
            raise ValueError("SparseVec wraps a vlen x 1 HyperMatrix")
        self.hm = hm

    # -- metadata -------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.hm.nrows

    @property
    def shape(self):
        return (self.hm.nrows,)

    @property
    def nvals(self) -> int:
        return self.hm.nvals

    @property
    def type(self) -> Type:
        return self.hm.type

    @property
    def device(self) -> torch.device:
        return self.hm.device

    @property
    def _options(self):
        return self.hm._options

    def __repr__(self):  # pragma: no cover
        return (f"SparseVec<{self.type.name}> size {self.size}, "
                f"{self.nvals} entries")

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def from_coo(ids, vals, size: int, type: Optional[Type] = None,
                 dup: Optional[str] = "PLUS", device=None) -> "SparseVec":
        ids = np.asarray(ids, np.int64)
        return SparseVec(hyper_from_coo(
            ids, np.zeros(len(ids), np.int64), vals, size, 1, type=type,
            dup=dup, device=device))

    @staticmethod
    def from_vector(v) -> "SparseVec":
        """Bitmap Vector -> SparseVec on the Vector's device."""
        ids, vals = v.wait().extractTuples()
        return SparseVec.from_coo(ids, vals, v.size, type=v.type, dup=None,
                                  device=v.device)

    def to_vector(self):
        """SparseVec -> bitmap Vector on the same device (sizes up to
        2^26 only)."""
        from ..core.matrix import Vector
        if self.size > _DENSIFY_CAP:
            from ..ops.containers import UnsupportedContainer
            raise UnsupportedContainer(
                f"SparseVec of size {self.size} cannot densify; stay "
                f"sparse")
        hm = self.hm.wait()
        n = hm.nvals
        ids = hm.rowids[:n]
        dv = zeros_like_typed(self.size, self.type, self.device)
        dp = torch.zeros(self.size, dtype=torch.bool, device=self.device)

        def put(d, v):
            d[ids] = v[:n]
        tree_map(put, dv, hm.values)
        dp[ids] = True
        return Vector(dv, dp, self.type)

    # -- accessors -------------------------------------------------------------
    def extractTuples(self):
        I, _, X = self.hm.extractTuples()
        return I, X

    def ids(self) -> np.ndarray:
        return self.extractTuples()[0]

    def dup(self) -> "SparseVec":
        return SparseVec(self.hm)

    # -- element mutation (pending tuples ride the wrapped matrix) -------------
    def wait(self) -> "SparseVec":
        h = self.hm.wait()
        return self if h is self.hm else SparseVec(h)

    def setElement(self, value, i: int, *, accum=None,
                   blocking=None) -> "SparseVec":
        return SparseVec(self.hm.setElement(value, i, 0, accum=accum,
                                            blocking=blocking))

    def extractElement(self, i: int):
        return self.hm.extractElement(i, 0)

    def removeElement(self, i: int) -> "SparseVec":
        return SparseVec(self.hm.removeElement(i, 0))

    def resize(self, n: int) -> "SparseVec":
        return SparseVec(self.hm.resize(n, 1))

    def clear(self) -> "SparseVec":
        return SparseVec(self.hm.clear())
