"""Object equality testing (reference ``Demo/Source/isequal.c`` and the
test suite's ``isequal_roundoff.m``).

Counterpart of ``graphblas_tpu/utils/compare.py``, over every container
of the port: bitmap ``Matrix``/``Vector``, ``CsrMatrix``/``CscMatrix``,
``HyperMatrix``/``HyperCscMatrix`` and ``SparseVec``, in any pairing
of the same kind (matrix against matrix, vector against vector).  The
comparison runs on the containers' device: each side's entries become
row-major (i, j, value) tensors there, and only the boolean answer
crosses to the host.
"""

from __future__ import annotations

import torch

from ..core.matrix import Matrix, Vector
from ..core.types import FC64, FP64, Type, cast

__all__ = ["isequal"]


def isequal(A, B, typecheck: bool = True, rtol: float = 0.0) -> bool:
    """True when A and B have the same dims, pattern, and values
    (optionally same type; ``rtol`` > 0 gives roundoff-tolerant float
    comparison like ``isequal_roundoff.m``).  NaN != NaN, as in the
    reference's isequal.c."""
    if _is_vector(A) != _is_vector(B):
        return False
    if tuple(A.shape) != tuple(B.shape):
        return False
    if typecheck and A.type.name != B.type.name:
        return False
    if A.type.is_udt != B.type.is_udt:
        return False
    Ia, Ja, va = _entries(A.wait())
    Ib, Jb, vb = _entries(B.wait())
    if Ia.numel() != Ib.numel():
        return False
    Ib, Jb = Ib.to(Ia.device), Jb.to(Ia.device)
    if not bool(torch.equal(Ia, Ib) and torch.equal(Ja, Jb)):
        return False
    if A.type.is_udt:
        return _fields_eq(va, vb, A.type, B.type, rtol, Ia.device)
    return _val_eq(va, vb.to(Ia.device), A.type, B.type, rtol)


def _is_vector(X) -> bool:
    from ..sparse.vector import SparseVec
    return isinstance(X, (Vector, SparseVec))


def _entries(X):
    """(I, J, values) of X's entries in row-major order, int64 indices,
    values in the type's storage (a dict per field for a struct), on
    X's device.  A vector's entries are (i, 0)."""
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    from ..sparse.vector import SparseVec
    from .tree import tree_map
    if isinstance(X, (Matrix, Vector)):
        pat = X.pattern if isinstance(X, Matrix) else X.pattern[:, None]
        I, J = torch.nonzero(pat, as_tuple=True)
        vals = tree_map(lambda v: v.reshape(pat.shape)[I, J], X.values)
        return I, J, vals
    if isinstance(X, SparseVec):
        X = X.hm
    if isinstance(X, (CsrMatrix, HyperMatrix)):
        n = X.nvals
        return (X.rowids[:n].long(), X.indices[:n].long(),
                tree_map(lambda v: v[:n], X.values))
    if isinstance(X, (CscMatrix, HyperCscMatrix)):
        # the stored transpose is column-major (j, then i): a stable
        # sort on i makes it row-major
        J, I, vals = _entries(X.tr)
        order = torch.argsort(I, stable=True)
        return I[order], J[order], tree_map(lambda v: v[order], vals)
    raise TypeError(f"not a GraphBLAS container: {type(X)}")


def _fields_eq(va: dict, vb: dict, ta: Type, tb: Type, rtol: float,
               device) -> bool:
    if not isinstance(vb, dict) or set(va) != set(vb):
        return False
    fa, fb = dict(ta.fields), dict(tb.fields)
    for k in va:
        if fa[k].is_udt != fb[k].is_udt:
            return False
        if fa[k].is_udt:
            if not _fields_eq(va[k], vb[k], fa[k], fb[k], rtol, device):
                return False
        elif not _val_eq(va[k], vb[k].to(device), fa[k], fb[k], rtol):
            return False
    return True


def _val_eq(a: torch.Tensor, b: torch.Tensor, ta: Type, tb: Type,
            rtol: float) -> bool:
    if ta.name != tb.name:
        # mixed types compare by value, as numpy compares them
        common = FC64 if (ta.is_complex or tb.is_complex) else FP64
        a, b = cast(a, common, ta), cast(b, common, tb)
    elif rtol > 0 and ta.is_unsigned:
        a, b = cast(a, FP64, ta), cast(b, FP64, tb)
    if rtol > 0:
        # pure relative comparison (isequal_roundoff.m has no absolute
        # term; an absolute term would mask small-magnitude errors)
        if not (a.is_floating_point() or a.is_complex()):
            a, b = a.to(torch.float64), b.to(torch.float64)
        return bool(torch.isclose(a, b, rtol=rtol, atol=0.0).all())
    return bool((a == b).all())
