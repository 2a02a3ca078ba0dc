"""Transpose and Kronecker product.

Counterpart of ``graphblas_tpu/ops/transpose.py``.  Reference:
``Source/GB_transpose.c`` (bucket transpose, optionally fused with a
unary op + typecast) and ``GB_kron.c`` / ``GB_kron_kernel.c``.  On the
bitmap ``Matrix`` a transpose permutes the dense tensors and kron is a
broadcast-reshape.  Sparse containers transpose by the tuple resort of
``CsrMatrix.T`` (the JAX package's, host side; the reference's bucket
transpose is a counting sort too) and kron by tuple arithmetic: the
output's (i, j) list is the outer sum of the operands' tuple lists,
``GB_kron_kernel.c:9-17``'s loop, vectorized.  A hypersparse output
(``HyperMatrix``, or ``HyperCscMatrix`` in the transposed frame) takes
the pair re-sort of ``hyper_transpose`` and a hypersparse kron build,
then ``hyper_accum_mask``.  Struct values of a user-defined type move
leaf by leaf in every form.
"""

from __future__ import annotations

from typing import Optional

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector, device_values, host_values
from ..core.ops import BinaryOp, UnaryOp
from ..core.types import cast, cast_result
from ..utils.tree import tree_map
from ..utils import counters
from ..sparse.vector import SparseVec
from .containers import (UnsupportedContainer, require_builtin,
                         to_bitmap_operand, to_csr_operand)
from .ewise import (csr_frame, finish_csr, finish_hyper, hyper_frame,
                    require_args)

__all__ = ["transpose", "kron"]


def _matrix_output(what: str, C) -> None:
    """transpose and kron write matrices: a vector output raises."""
    if isinstance(C, (Vector, SparseVec)):
        raise UnsupportedContainer(f"{what} output C: expected a matrix "
                                   f"container, got {type(C).__name__}")


@counters.counted("transpose")
def transpose(C, M, accum: Optional[BinaryOp], A,
              desc: Optional[Descriptor] = None,
              op: Optional[UnaryOp] = None):
    """C<M> = accum(C, A').  With INP0=TRAN this is C<M> = accum(C, A)
    (the double-transpose shortcut, ``GrB_transpose.c``)."""
    require_args("transpose", C, M, A)
    from ..core.resolve import resolve_accum, resolve_unary
    accum = resolve_accum(accum, "transpose accum", None, C, A)
    if op is not None:
        op = resolve_unary(op, "transpose op", None, A, C)
    require_builtin("transpose op", op, accum)
    d = desc_of(desc)
    _matrix_output("transpose", C)
    frame = hyper_frame(C, M)
    if frame is not None:
        from ..sparse.hyper import hyper_apply
        Cw, operand, Mw, wrap = frame
        T = operand(A, not d.tran0, "transpose input")
        if op is not None:
            T = hyper_apply(op, T, ztype=op.ztype)
        if T.shape != Cw.shape:
            raise DimensionMismatch(f"A' is {T.shape}, C is {Cw.shape}")
        return finish_hyper(Cw, Mw, T, accum, d, wrap)
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(C, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_apply
        Cw, T, Mw, csc = csr_frame(C, A, not d.tran0, M, "transpose")
        if op is not None:
            T = csr_apply(op, T)
        if T.shape != Cw.shape:
            raise DimensionMismatch(f"A' is {T.shape}, C is {C.shape}")
        return finish_csr(Cw, Mw, T, accum, d, csc)
    A = to_bitmap_operand(A, "transpose input")
    M = to_bitmap_operand(M, "mask") if M is not None else None
    vals, pat, t = A.values, A.pattern, A.type
    if not d.tran0:
        vals, pat = tree_map(lambda v: v.T, vals), pat.T
    if op is not None:
        vals = cast_result(op(cast(vals, op.xtype, t)), op.ztype)
        t = op.ztype
    T = Matrix(tree_map(lambda v: v.contiguous(), vals), pat.contiguous(),
               t).canonical()
    return accum_mask(C, M, T, accum, d)


def _kron_tuples(op: BinaryOp, A, B):
    """(I, J, Z) of kron(A, B) from the operand tuple lists: the
    vectorized ``GB_kron_kernel.c`` loop; Z is computed by the op on A's
    device and returned as host values of its ztype.  Output nnz =
    nnzA * nnzB exactly (pairs are unique when the inputs are)."""
    IA, JA, XA = A.extractTuples()
    IB, JB, XB = B.extractTuples()
    bm, bn = B.shape
    I = (IA[:, None] * bm + IB[None, :]).ravel()
    J = (JA[:, None] * bn + JB[None, :]).ravel()
    dev = A.device

    def typed(X, src, dst):
        return cast(device_values(X, src, dev), dst, src)
    a = tree_map(lambda v: v[:, None], typed(XA, A.type, op.xtype))
    b = tree_map(lambda v: v[None, :], typed(XB, B.type, op.ytype))
    z = cast_result(op(a, b), op.ztype)
    shape = (len(IA), len(IB))
    Z = host_values(tree_map(lambda v: v.expand(shape).reshape(-1), z),
                    op.ztype)
    return I, J, Z


@counters.counted("kron")
def kron(C, M, accum: Optional[BinaryOp], op: BinaryOp, A, B,
         desc: Optional[Descriptor] = None):
    """C<M> = accum(C, kron(A, B)) with multiply op (``GxB_kron``)."""
    require_args("kron", C, M, A, B)
    from ..core.resolve import resolve_accum, resolve_binary
    op = resolve_binary(op, "kron op", None, A, B, C)
    accum = resolve_accum(accum, "kron accum", None, C, A)
    require_builtin("kron op", op, accum)
    d = desc_of(desc)
    _matrix_output("kron", C)
    frame = hyper_frame(C, M)
    if frame is not None:
        # kron(A, B)' = kron(A', B'): the by-col frame transposes operands
        from ..sparse.hyper import hyper_from_coo
        Cw, operand, Mw, wrap = frame
        Aw = operand(A, d.tran0, "kron input A")
        Bw = operand(B, d.tran1, "kron input B")
        I, J, Z = _kron_tuples(op, Aw, Bw)
        T = hyper_from_coo(I, J, Z, Aw.nrows * Bw.nrows,
                           Aw.ncols * Bw.ncols, type=op.ztype, dup=None,
                           device=Cw.device)
        if T.shape != Cw.shape:
            raise DimensionMismatch(f"kron is {T.shape}, C is {Cw.shape}")
        return finish_hyper(Cw, Mw, T, accum, d, wrap)
    from ..sparse.container import CscMatrix, CsrMatrix, csr_from_coo
    if isinstance(C, (CsrMatrix, CscMatrix)):
        # kron(A, B)' = kron(A', B'): the by-col frame transposes operands
        Cw, Aw, Mw, csc = csr_frame(C, A, d.tran0, M, "kron A")
        Bw = to_csr_operand(B, csc ^ d.tran1, "kron input B")
        I, J, Z = _kron_tuples(op, Aw, Bw)
        T = csr_from_coo(I, J, Z, Aw.nrows * Bw.nrows, Aw.ncols * Bw.ncols,
                         type=op.ztype, sum_duplicates=False,
                         device=Cw.device)
        if T.shape != Cw.shape:
            raise DimensionMismatch(f"kron is {T.shape}, C is {C.shape}")
        return finish_csr(Cw, Mw, T, accum, d, csc)
    A = to_bitmap_operand(A, "kron input A")
    B = to_bitmap_operand(B, "kron input B")
    M = to_bitmap_operand(M, "mask") if M is not None else None
    from .mxm import _oriented
    Av, Ap = _oriented(A, d.tran0)
    Bv, Bp = _oriented(B, d.tran1)
    am, an = Ap.shape
    bm, bn = Bp.shape
    a = tree_map(lambda v: v[:, None, :, None], cast(Av, op.xtype, A.type))
    b = tree_map(lambda v: v[None, :, None, :], cast(Bv, op.ytype, B.type))
    vals = cast_result(op(a, b), op.ztype)
    vals = tree_map(lambda v: v.expand(am, bm, an, bn).reshape(
        am * bm, an * bn), vals)
    pat = (Ap[:, None, :, None] & Bp[None, :, None, :]).reshape(
        am * bm, an * bn)
    T = Matrix(vals, pat, op.ztype).canonical()
    return accum_mask(C, M, T, accum, d)
