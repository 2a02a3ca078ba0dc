"""assign / subassign: the reference's largest correctness surface.

Counterpart of ``graphblas_tpu/ops/assign.py``.  Reference:
``Source/GB_assign.c`` (GrB_assign semantics — the mask covers ALL of
C) and ``Source/GB_subassign_kernel.c`` (GxB_subassign — the mask
covers only C(I,J), 48 case combinations of index kinds x mask x accum
x scalar x C_replace).  The executable specs are
``Test/GB_spec_assign.m`` and ``Test/GB_spec_subassign.m``, which this
module transcribes: on the bitmap container every case is a gather of
C(I,J), the accum/mask epilogue, and a scatter back, so the 48-way case
explosion (and the zombie/pending machinery it manages) disappears.
A ``CsrMatrix`` output takes the sparse forms of
:mod:`graphblas_tpu_torch.sparse.assign`, a ``CscMatrix`` runs them in
the transposed frame (I and J swapped); a ``HyperMatrix`` output (and
a ``HyperCscMatrix`` in its transposed frame, a ``SparseVec`` as its
n x 1 matrix) takes the pair-key forms of
:mod:`graphblas_tpu_torch.sparse.hyper_assign`, at any dimension.

Assign with duplicate indices is undefined in the spec: the sparse
forms raise ``InvalidValue``, the bitmap scatter keeps one of the
values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask, accum_values, apply_mask
from ..core.matrix import Matrix, Vector
from ..core.ops import BinaryOp
from ..core.types import Type, cast_value, full_typed
from ..utils.tree import tree_map
from ..utils import counters
from ..utils.indices import ALL, is_all, normalize_indices
from .containers import (require_container, to_csr_operand,
                         to_hyper_operand, vec_hyper_operand)

__all__ = ["assign", "subassign", "assign_scalar", "subassign_scalar",
           "row_assign", "col_assign", "assign_vector", "subassign_vector"]


def _scalar_matrix(scalar, ni: int, nj: int, t: Type, device) -> Matrix:
    """Scalar expansion: an implicit ni x nj all-present matrix."""
    return Matrix(full_typed((ni, nj), cast_value(scalar, t), t, device),
                  torch.ones((ni, nj), dtype=torch.bool, device=device), t)


def _grid(Ii: np.ndarray, Jj: np.ndarray, device):
    """Index tensors that select the rows Ii and the columns Jj (the
    np.ix_ grid)."""
    return (torch.from_numpy(Ii).to(device)[:, None],
            torch.from_numpy(Jj).to(device)[None, :])


def _gather(X: Matrix, Ii, Jj) -> Matrix:
    ix = _grid(Ii, Jj, X.device)
    return Matrix(tree_map(lambda v: v[ix], X.values), X.pattern[ix],
                  X.type)


def _scatter(C: Matrix, Ii, Jj, sub: Matrix) -> Matrix:
    ix = _grid(Ii, Jj, C.device)
    vals = tree_map(lambda v: v.clone(), C.values)
    pat = C.pattern.clone()
    tree_map(lambda v, s: v.__setitem__(ix, s), vals, sub.values)
    pat[ix] = sub.pattern
    return Matrix(vals, pat, C.type).canonical()


def _as_matrix(x, col: bool = True):
    """A Vector as an n x 1 (or 1 x n) Matrix view, pending tuples folded
    first (the view cannot carry them)."""
    if x is None or isinstance(x, Matrix):
        return x
    x = x.wait()
    ax = (slice(None), None) if col else (None, slice(None))
    return Matrix(tree_map(lambda v: v[ax], x.values), x.pattern[ax],
                  x.type)


def _to_vector(m: Matrix, col: bool = True) -> Vector:
    ax = (slice(None), 0) if col else (0, slice(None))
    return Vector(tree_map(lambda v: v[ax], m.values), m.pattern[ax],
                  m.type)


def _transposed(A: Matrix) -> Matrix:
    return Matrix(tree_map(lambda v: v.T, A.values), A.pattern.T, A.type)


def _operand(A, ni: int, nj: int, C: Matrix, tran: bool,
             scalar: bool) -> Matrix:
    """The region-shaped operand: the scalar expanded, or A (transposed
    when asked) checked against |I| x |J| = ``ni`` x ``nj``."""
    if scalar:
        return _scalar_matrix(A, ni, nj, C.type, C.device)
    if not isinstance(A, Matrix):
        from .containers import to_bitmap_operand
        A = to_bitmap_operand(A, "assign input A")
    A = A.wait()
    if tran:
        A = _transposed(A)
    if A.shape != (ni, nj):
        raise DimensionMismatch(f"A is {A.shape}, I x J is {(ni, nj)}")
    return A


def _sparse_route(fn, hfn, C, M, accum, A, I, J, desc, scalar: bool):
    """The sparse forms: a CsrMatrix runs ``fn`` as it is, a HyperMatrix
    runs ``hfn``, a CscMatrix or HyperCscMatrix its form in the stored
    transpose's frame (I and J swapped); None for a bitmap output."""
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(C, CsrMatrix):
        return fn(C, M, accum, A, I, J, desc, scalar=scalar)
    if isinstance(C, HyperMatrix):
        return hfn(C, M, accum, A, I, J, desc, scalar=scalar)
    if isinstance(C, (CscMatrix, HyperCscMatrix)):
        hyper = isinstance(C, HyperCscMatrix)
        conv = to_hyper_operand if hyper else to_csr_operand
        d0 = desc_of(desc)
        Aw = A if scalar else conv(A, not d0.tran0, "assign input")
        Mw = conv(M, True, "mask") if M is not None else None
        return type(C)((hfn if hyper else fn)(
            C.tr, Mw, accum, Aw, J, I, dataclasses.replace(d0, tran0=False),
            scalar=scalar))
    return None


def _prologue(what: str, C, M, accum, A, scalar: bool):
    require_container(C, f"{what} output C")
    require_container(M, f"{what} mask", none_ok=True)
    if not scalar:
        require_container(A, f"{what} input A")
    from ..core.resolve import resolve_accum
    return resolve_accum(accum, f"{what} accum", None, C, A)


@counters.counted("assign")
def assign(C, M, accum: Optional[BinaryOp], A: Union[Matrix, Any],
           I: Any = None, J: Any = None, desc: Optional[Descriptor] = None,
           *, scalar: bool = False):
    """C<M>(I,J) = accum(C(I,J), A) — GrB_assign; M is C-sized.

    Transcribes ``Test/GB_spec_assign.m``: Z = C; Z(I,J) =
    accum(C(I,J), A); then C<M> = Z with C_replace over all of C.  On a
    bitmap output (a ``Vector`` included) that is the span
    ``gb.engines.bitmap_assign``.
    """
    accum = _prologue("assign", C, M, accum, A, scalar)
    from ..sparse.assign import csr_assign
    from ..sparse.hyper_assign import hyper_assign
    out = _sparse_route(csr_assign, hyper_assign, C, M, accum, A, I, J,
                        desc, scalar)
    if out is not None:
        return out
    with counters.span("gb.engines.bitmap_assign"):
        return _bitmap_assign(C, M, accum, A, I, J, desc, scalar)


def _bitmap_assign(C: Matrix, M, accum, A, I, J, desc,
                   scalar: bool) -> Matrix:
    d = desc_of(desc)
    C = C.wait()
    if M is not None:
        M = M.wait()
    if is_all(I) and is_all(J):
        # C(:,:) is C: no index lists, gather or scatter
        A = _operand(A, C.nrows, C.ncols, C, d.tran0, scalar)
        zvals, zpat = accum_values(C, A, accum)
        return apply_mask(C, M, zvals, zpat, d)
    Ii = normalize_indices(I, C.nrows, unique=scalar)
    Jj = normalize_indices(J, C.ncols, unique=scalar)
    A = _operand(A, len(Ii), len(Jj), C, d.tran0, scalar)
    S = _gather(C, Ii, Jj)
    zij_vals, zij_pat = accum_values(S, A, accum)
    Z = _scatter(C, Ii, Jj, Matrix(zij_vals, zij_pat, C.type))
    return apply_mask(C, M, Z.values, Z.pattern, d)


@counters.counted("subassign")
def subassign(C, M, accum: Optional[BinaryOp], A: Union[Matrix, Any],
              I: Any = None, J: Any = None,
              desc: Optional[Descriptor] = None, *, scalar: bool = False):
    """C(I,J)<M> = accum(C(I,J), A) — GxB_subassign; M is |I| x |J|;
    entries outside C(I,J) are never modified (``GB_spec_subassign.m``)."""
    accum = _prologue("subassign", C, M, accum, A, scalar)
    from ..sparse.assign import csr_subassign
    from ..sparse.hyper_assign import hyper_subassign
    out = _sparse_route(csr_subassign, hyper_subassign, C, M, accum, A, I,
                        J, desc, scalar)
    if out is not None:
        return out
    d = desc_of(desc)
    C = C.wait()
    Ii = normalize_indices(I, C.nrows)
    Jj = normalize_indices(J, C.ncols)
    A = _operand(A, len(Ii), len(Jj), C, d.tran0, scalar)
    if M is not None:
        M = _as_matrix(M.wait())
        if M.shape != (len(Ii), len(Jj)):
            # vector subassign lifts the mask to a column; the row case
            # comes transposed
            if M.shape == (len(Jj), len(Ii)):
                M = _transposed(M)
            else:
                raise DimensionMismatch(
                    f"mask is {M.shape}, I x J is {(len(Ii), len(Jj))}")
    S = _gather(C, Ii, Jj)
    Snew = accum_mask(S, M, A, accum, d)
    return _scatter(C, Ii, Jj, Snew)


# -- scalar / vector / row / col convenience wrappers (GrB_*_assign family) --

def assign_scalar(C, M, accum, x, I=None, J=None, desc=None):
    """GrB_Matrix_assign_TYPE: C<M>(I,J) = accum(C(I,J), scalar)."""
    return assign(C, M, accum, x, I, J, desc, scalar=True)


def subassign_scalar(C, M, accum, x, I=None, J=None, desc=None):
    return subassign(C, M, accum, x, I, J, desc, scalar=True)


def _vector_form(fn, hfn, what: str, w, m, accum, u, I, desc,
                 scalar: bool):
    require_container(w, f"{what} output w")
    from ..sparse.vector import SparseVec
    if isinstance(w, SparseVec):
        accum = _prologue(what, w, m, accum, u, scalar)
        uh = u if scalar else vec_hyper_operand(u, f"{what} input")
        mh = vec_hyper_operand(m, "mask") if m is not None else None
        return SparseVec(hfn(w.hm, mh, accum, uh, I, [0], desc,
                             scalar=scalar))
    Cm = _as_matrix(w)
    Mm = _as_matrix(m)
    Am = u if scalar else _as_matrix(u)
    # the n x 1 view's one column is all of its columns
    return _to_vector(fn(Cm, Mm, accum, Am, I, ALL, desc, scalar=scalar))


def assign_vector(w: Vector, m: Optional[Vector], accum, u, I=None,
                  desc=None, *, scalar: bool = False) -> Vector:
    """GrB_Vector_assign: w<m>(I) = accum(w(I), u)."""
    from ..sparse.hyper_assign import hyper_assign
    return _vector_form(assign, hyper_assign, "assign_vector", w, m, accum,
                        u, I, desc, scalar)


def subassign_vector(w: Vector, m: Optional[Vector], accum, u, I=None,
                     desc=None, *, scalar: bool = False) -> Vector:
    """GxB_Vector_subassign: w(I)<m> = accum(w(I), u)."""
    from ..sparse.hyper_assign import hyper_subassign
    return _vector_form(subassign, hyper_subassign, "subassign_vector", w,
                        m, accum, u, I, desc, scalar)


def row_assign(C: Matrix, m: Optional[Vector], accum, u: Vector,
               i: int, J=None, desc=None) -> Matrix:
    """GrB_Row_assign: C<m'>(i,J) = accum(C(i,J), u'); the mask is a
    column vector of size ncols(C) and only row i is affected
    (``Test/GB_spec_Row_assign.m``)."""
    C = C.wait()
    X = Vector(tree_map(lambda v: v[i, :], C.values), C.pattern[i, :],
               C.type)
    X = assign_vector(X, m, accum, u, J, desc)
    vals = tree_map(lambda v: v.clone(), C.values)
    pat = C.pattern.clone()
    tree_map(lambda v, x: v.__setitem__((i, slice(None)), x), vals,
             X.values)
    pat[i, :] = X.pattern
    return Matrix(vals, pat, C.type).canonical()


def col_assign(C: Matrix, m: Optional[Vector], accum, u: Vector,
               I=None, j: int = 0, desc=None) -> Matrix:
    """GrB_Col_assign: C<m>(I,j) = accum(C(I,j), u)."""
    C = C.wait()
    X = Vector(tree_map(lambda v: v[:, j], C.values), C.pattern[:, j],
               C.type)
    X = assign_vector(X, m, accum, u, I, desc)
    vals = tree_map(lambda v: v.clone(), C.values)
    pat = C.pattern.clone()
    tree_map(lambda v, x: v.__setitem__((slice(None), j), x), vals,
             X.values)
    pat[:, j] = X.pattern
    return Matrix(vals, pat, C.type).canonical()
