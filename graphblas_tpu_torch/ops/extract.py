"""Submatrix extraction: C<M> = accum(C, A(I,J)).

Counterpart of ``graphblas_tpu/ops/extract.py``.  Reference:
``Source/GB_extract.c`` driving ``Template/GB_subref_template.c``
(symbolic/numeric subref with binary search, I-inverse buckets, zombie
awareness).  On the bitmap container extraction is one gather of rows
and columns (duplicate indices allowed); a ``CsrMatrix`` or
``CscMatrix`` output takes the sparse form of
:mod:`graphblas_tpu_torch.sparse.assign`, a hypersparse output
(``HyperMatrix``, ``HyperCscMatrix`` in the transposed frame,
``SparseVec``) the pair-key form of
:mod:`graphblas_tpu_torch.sparse.hyper_assign` at any dimension.
Struct values of a user-defined type are gathered leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector
from ..core.ops import BinaryOp
from ..utils import counters
from ..utils.indices import normalize_indices
from ..utils.tree import tree_map
from .containers import (UnsupportedContainer, require_container,
                         to_csr_operand, to_hyper_operand, vec_hyper_operand)

__all__ = ["extract", "extract_vector", "extract_col"]


def _ix(X: torch.Tensor, Ii: np.ndarray, Jj: np.ndarray) -> torch.Tensor:
    """X[np.ix_(Ii, Jj)] on X's device."""
    dev = X.device
    return X.index_select(0, torch.from_numpy(Ii).to(dev)).index_select(
        1, torch.from_numpy(Jj).to(dev))


def _bitmap(X, what: str):
    if not isinstance(X, Matrix):
        raise UnsupportedContainer(
            f"{what}: expected a bitmap Matrix, got {type(X).__name__}")
    return X.wait()


@counters.counted("extract")
def extract(C, M, accum: Optional[BinaryOp], A, I: Any = None,
            J: Any = None, desc: Optional[Descriptor] = None):
    """C<M> = accum(C, A(I,J)) (reference ``GrB_Matrix_extract``).

    A CsrMatrix ``C`` routes to the O(nnz) sparse form, a CscMatrix runs
    it in the transposed frame (I and J swapped); a CsrMatrix or
    CscMatrix ``A`` with a bitmap ``C`` extracts sparsely then lands the
    (region-sized) result on the bitmap — A itself is never densified.
    """
    require_container(C, "extract output C")
    require_container(M, "extract mask", none_ok=True)
    require_container(A, "extract input A")
    from ..sparse.assign import csr_extract, csr_subref
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_assign import hyper_extract
    from ..sparse.hyper_csc import HyperCscMatrix
    d = desc_of(desc)
    if isinstance(C, HyperCscMatrix):
        Aw = to_hyper_operand(A, not d.tran0, "extract input")
        Mw = to_hyper_operand(M, True, "mask") if M is not None else None
        return HyperCscMatrix(hyper_extract(
            C.tr, Mw, accum, Aw, J, I, dataclasses.replace(d, tran0=False)))
    if isinstance(C, HyperMatrix):
        return hyper_extract(C, M, accum, A, I, J, desc)
    if isinstance(C, CscMatrix):
        Aw = to_csr_operand(A, not d.tran0, "extract input")
        Mw = to_csr_operand(M, True, "mask") if M is not None else None
        return CscMatrix(csr_extract(C.tr, Mw, accum, Aw, J, I,
                                     dataclasses.replace(d, tran0=False)))
    if isinstance(C, CsrMatrix):
        return csr_extract(C, M, accum, A, I, J, desc)
    if isinstance(A, (CsrMatrix, CscMatrix, HyperMatrix)):
        At = to_csr_operand(A, d.tran0, "extract input")
        T = csr_subref(At, I, J).to_matrix()
        return accum_mask(C, M, T, accum, d)
    A = _bitmap(A, "extract input A")
    vals, pat = A.values, A.pattern
    if d.tran0:
        vals, pat = tree_map(lambda v: v.T, vals), pat.T
    nr, nc = pat.shape
    Ii = normalize_indices(I, nr)
    Jj = normalize_indices(J, nc)
    T = Matrix(tree_map(lambda v: _ix(v, Ii, Jj), vals), _ix(pat, Ii, Jj),
               A.type)
    return accum_mask(C, M, T, accum, d)


@counters.counted("extract_vector")
def extract_vector(w: Vector, m: Optional[Vector],
                   accum: Optional[BinaryOp], u: Vector, I: Any = None,
                   desc: Optional[Descriptor] = None) -> Vector:
    """w<m> = accum(w, u(I)) (``GrB_Vector_extract``)."""
    require_container(w, "extract output w")
    require_container(m, "extract mask", none_ok=True)
    require_container(u, "extract input u")
    from ..sparse.vector import SparseVec
    if isinstance(w, SparseVec):
        from ..sparse.hyper_assign import hyper_extract
        uh = vec_hyper_operand(u, "extract input")
        mh = vec_hyper_operand(m, "mask") if m is not None else None
        return SparseVec(hyper_extract(w.hm, mh, accum, uh, I, [0], desc))
    d = desc_of(desc)
    u = u.wait()
    Ii = torch.from_numpy(normalize_indices(I, u.size)).to(u.device)
    T = Vector(tree_map(lambda v: v[Ii], u.values), u.pattern[Ii], u.type)
    return accum_mask(w, m, T, accum, d)


def extract_col(w: Vector, m: Optional[Vector], accum: Optional[BinaryOp],
                A: Matrix, I: Any = None, j: int = 0,
                desc: Optional[Descriptor] = None) -> Vector:
    """w<m> = accum(w, A(I,j)); TRAN0 extracts the row A(j,I)'
    (``GrB_Col_extract``)."""
    d = desc_of(desc)
    A = _bitmap(A, "extract_col input A")
    vals, pat = A.values, A.pattern
    if d.tran0:
        vals, pat = tree_map(lambda v: v.T, vals), pat.T
    Ii = torch.from_numpy(normalize_indices(I, pat.shape[0])).to(A.device)
    T = Vector(tree_map(lambda v: v[Ii, j], vals), pat[Ii, j], A.type)
    return accum_mask(w, m, T, accum, d)
