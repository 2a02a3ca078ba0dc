"""Container canonicalization for the op orchestrators.

Counterpart of ``graphblas_tpu/ops/containers.py`` for the containers
the port carries: the CSR ``CsrMatrix``, its by-column twin
``CscMatrix``, the bitmap ``Matrix`` and the bitmap ``Vector``.  The
reference canonicalizes every operand internally
(``GB_AxB_meta.c:86-185``); here the OUTPUT container decides the
compute representation and operands convert toward it, their pending
tuples folded first.  The hypersparse
containers (``HyperMatrix``, ``SparseVec``) come with a later slice.
"""

from __future__ import annotations

from ..core.errors import GraphBLASError
from ..core.matrix import Matrix, Vector

__all__ = ["UnsupportedContainer", "require_container", "require_builtin",
           "to_csr_operand", "to_bitmap_operand", "new_like"]


class UnsupportedContainer(GraphBLASError):
    """Typed error naming the supported path: container mismatches must
    not leak raw AttributeErrors."""


def require_container(X, what: str = "operand",
                      none_ok: bool = False) -> None:
    """Typed pre-flight guard: every public op calls this on its
    container arguments before any attribute access, so an unknown
    object raises :class:`UnsupportedContainer`."""
    if X is None and none_ok:
        return
    from ..sparse.container import CscMatrix, CsrMatrix
    if not isinstance(X, (Matrix, Vector, CsrMatrix, CscMatrix)):
        raise UnsupportedContainer(
            f"{what}: expected a GraphBLAS container of this port "
            f"(CsrMatrix, CscMatrix, Matrix or Vector), got "
            f"{type(X).__name__}; the hypersparse containers (HyperMatrix, "
            f"HyperCscMatrix, SparseVec) come with a later slice of the "
            f"port (ROADMAP.md queue 1, item 10)")


def require_builtin(what: str, *ops) -> None:
    """Typed guard on operators: every type an op, monoid or accum names
    must be one of the port's builtin types; a user-defined type raises
    :class:`UnsupportedOp` naming ROADMAP.md queue 1, item 7."""
    from ..core.resolve import UnsupportedOp
    from ..core.types import Type
    for op in ops:
        op = getattr(op, "op", op)          # a Monoid's binary op
        for attr in ("ztype", "xtype", "ytype"):
            t = getattr(op, attr, None)
            if t is not None and not isinstance(t, Type):
                raise UnsupportedOp(
                    f"{what}: {attr} {t!r} is not a builtin type of this "
                    f"port; user-defined types come with a later slice "
                    f"(ROADMAP.md queue 1, item 7)")


def to_csr_operand(X, tran: bool = False, what: str = "operand"):
    """A CsrMatrix, CscMatrix or bitmap Matrix -> CsrMatrix, optionally
    transposed (a CscMatrix transposes for free); pending tuples are
    folded first (the GB_WAIT discipline)."""
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(X, (CsrMatrix, CscMatrix, Matrix)):
        X = X.wait()
    if isinstance(X, CsrMatrix):
        return X.T() if tran else X
    if isinstance(X, CscMatrix):
        return X.T() if tran else X.to_csr()
    if isinstance(X, Matrix):
        A = CsrMatrix.from_matrix(X)
        return A.T() if tran else A
    raise UnsupportedContainer(
        f"{what}: expected a matrix container, got {type(X).__name__}")


def to_bitmap_operand(X, what: str = "operand") -> Matrix:
    """A CsrMatrix, CscMatrix or bitmap Matrix -> bitmap Matrix (small
    dimensions only: the bitmap is dense), pending tuples folded."""
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(X, (CsrMatrix, CscMatrix)):
        return X.to_matrix()
    if isinstance(X, Matrix):
        return X.wait()
    raise UnsupportedContainer(
        f"{what}: expected a matrix container, got {type(X).__name__}")


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
