"""Container canonicalization for the op orchestrators.

Counterpart of ``graphblas_tpu/ops/containers.py``.  The reference
canonicalizes every operand internally (``GB_AxB_meta.c:86-185``); here
the OUTPUT container decides the compute representation (bitmap, CSR,
CSC or hypersparse) and operands convert toward it, their pending
tuples folded first.  Conversions are explicit and cost at most one
resort, the transpose the reference pays when formats disagree.  The
containers: the bitmap ``Matrix`` and ``Vector``, ``CsrMatrix`` and its
by-column twin ``CscMatrix``, the hypersparse ``HyperMatrix``, its
by-column twin ``HyperCscMatrix`` and the sparse vector ``SparseVec``.
"""

from __future__ import annotations

import functools

from ..core.errors import GraphBLASError
from ..core.matrix import Matrix, Vector

__all__ = ["UnsupportedContainer", "require_container", "require_builtin",
           "to_csr_operand", "to_hyper_operand", "to_bitmap_operand",
           "vec_hyper_operand", "is_sparse_container", "new_like"]

_CSR_DIM_CAP = 1 << 28  # an O(nrows) indptr stops being reasonable here


class UnsupportedContainer(GraphBLASError):
    """Typed error naming the supported path: container mismatches must
    not leak raw AttributeErrors."""


@functools.cache
def _containers():
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix
    return CsrMatrix, CscMatrix, HyperMatrix


@functools.cache
def _known_containers():
    from ..sparse.hyper_csc import HyperCscMatrix
    from ..sparse.vector import SparseVec
    return (Matrix, Vector, *_containers(), SparseVec, HyperCscMatrix)


def is_sparse_container(x) -> bool:
    return isinstance(x, _containers())


def require_container(X, what: str = "operand",
                      none_ok: bool = False) -> None:
    """Typed pre-flight guard: every public op calls this on its
    container arguments before any attribute access, so an unknown
    object raises :class:`UnsupportedContainer`."""
    if X is None and none_ok:
        return
    if not isinstance(X, _known_containers()):
        raise UnsupportedContainer(
            f"{what}: expected a GraphBLAS container (Matrix, Vector, "
            f"CsrMatrix, CscMatrix, HyperMatrix, SparseVec), got "
            f"{type(X).__name__}")


def require_builtin(what: str, *ops) -> None:
    """Typed guard on operators: every type an op, monoid or accum names
    must be a :class:`Type` (builtin, complex or user-defined); anything
    else raises :class:`UnsupportedOp`."""
    from ..core.resolve import UnsupportedOp
    from ..core.types import Type
    for op in ops:
        op = getattr(op, "op", op)          # a Monoid's binary op
        for attr in ("ztype", "xtype", "ytype"):
            t = getattr(op, attr, None)
            if t is not None and not isinstance(t, Type):
                raise UnsupportedOp(
                    f"{what}: {attr} {t!r} is not a GraphBLAS Type")


def to_csr_operand(X, tran: bool = False, what: str = "operand"):
    """Any matrix container -> CsrMatrix, optionally transposed (a
    CscMatrix transposes for free); a HyperMatrix converts only when its
    dimensions admit an O(nrows) indptr.  Pending tuples fold first
    (the GB_WAIT discipline)."""
    CsrMatrix, CscMatrix, HyperMatrix = _containers()
    from ..sparse.hyper_csc import HyperCscMatrix
    if hasattr(X, "wait") and not isinstance(X, Vector):
        X = X.wait()
    if isinstance(X, CsrMatrix):
        return X.T() if tran else X
    if isinstance(X, CscMatrix):
        return X.T() if tran else X.to_csr()
    if isinstance(X, HyperCscMatrix):
        X = X.tr
        tran = not tran
    if isinstance(X, HyperMatrix):
        if max(X.nrows, X.ncols) > _CSR_DIM_CAP:
            raise UnsupportedContainer(
                f"{what}: HyperMatrix of dimension {X.shape} cannot "
                f"convert to CSR (indptr would be O(nrows)); use a "
                f"hypersparse output container instead")
        A = X.to_csr()
        return A.T() if tran else A
    if isinstance(X, Matrix):
        A = CsrMatrix.from_matrix(X)
        return A.T() if tran else A
    raise UnsupportedContainer(
        f"{what}: expected a matrix container, got {type(X).__name__}")


def to_hyper_operand(X, tran: bool = False, what: str = "operand"):
    """Any matrix container -> HyperMatrix on its device, optionally
    transposed (a HyperCscMatrix or CscMatrix folds its orientation into
    the flag)."""
    CsrMatrix, CscMatrix, HyperMatrix = _containers()
    from ..sparse.hyper import hyper_transpose
    from ..sparse.hyper_csc import HyperCscMatrix
    if hasattr(X, "wait") and not isinstance(X, Vector):
        X = X.wait()
    if isinstance(X, HyperCscMatrix):
        X = X.tr                    # stored transpose: fold into flag
        tran = not tran
    if isinstance(X, HyperMatrix):
        return hyper_transpose(X) if tran else X
    if isinstance(X, CscMatrix):
        X = X.tr
        tran = not tran
    if isinstance(X, Matrix):
        X = CsrMatrix.from_matrix(X)
    if isinstance(X, CsrMatrix):
        H = HyperMatrix.from_csr(X)
        return hyper_transpose(H) if tran else H
    raise UnsupportedContainer(
        f"{what}: expected a matrix container, got {type(X).__name__}")


def vec_hyper_operand(X, what: str = "operand"):
    """Any vector container -> its vlen x 1 HyperMatrix (the reference's
    vector-is-a-matrix identity, ``GB_matrix.h:18-26``)."""
    from ..sparse.vector import SparseVec
    if isinstance(X, SparseVec):
        return X.wait().hm
    if isinstance(X, Vector):
        return SparseVec.from_vector(X).hm
    raise UnsupportedContainer(
        f"{what}: expected a vector container, got {type(X).__name__}")


def to_bitmap_operand(X, what: str = "operand"):
    """Any matrix container -> bitmap Matrix (small dimensions only: the
    bitmap is dense), pending tuples folded."""
    CsrMatrix, CscMatrix, HyperMatrix = _containers()
    from ..sparse.hyper_csc import HyperCscMatrix
    if hasattr(X, "wait") and not isinstance(X, Vector):
        X = X.wait()
    if isinstance(X, (CsrMatrix, CscMatrix)):
        return X.to_matrix()
    if isinstance(X, HyperCscMatrix):
        X = X.to_hyper()
    if isinstance(X, HyperMatrix):
        if max(X.nrows, X.ncols) > (1 << 16):
            raise UnsupportedContainer(
                f"{what}: HyperMatrix of dimension {X.shape} cannot "
                f"densify to a bitmap; use a sparse or hypersparse "
                f"output container")
        return X.to_csr().to_matrix()
    if not isinstance(X, Matrix):
        raise UnsupportedContainer(
            f"{what}: expected a matrix container, got "
            f"{type(X).__name__}")
    return X


def new_like(X, type, nrows: int, ncols: int):
    """An empty nrows x ncols output of ``type`` in X's kind of container
    (CsrMatrix, CscMatrix or bitmap Matrix) on X's device."""
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.esc import _empty_csr
    if isinstance(X, CsrMatrix):
        return _empty_csr(nrows, ncols, type, X.device)
    if isinstance(X, CscMatrix):
        return CscMatrix(_empty_csr(ncols, nrows, type, X.device))
    return Matrix.new(type, nrows, ncols, device=X.device)
