"""Elementwise operations: eWiseAdd (set union), eWiseMult
(intersection), apply and select.

Counterpart of ``graphblas_tpu/ops/ewise.py``.  Reference:
``Source/GB_add.c`` (4-case per-vector union merge), ``GB_emult.c``
(intersection merge), ``GB_eWise.c`` (orchestrator), ``GB_apply.c``,
``GB_select.c``.  The OUTPUT container picks the engine, as in the JAX
package: a bitmap ``Matrix`` or ``Vector`` takes elementwise selects
over values and pattern (CSR operands convert to bitmaps, as there), a
``CsrMatrix`` or by-column ``CscMatrix`` the sort-merge engines of
:mod:`graphblas_tpu_torch.sparse.ewise` and the ``csr_accum_mask``
epilogue (a CSC output runs in the transposed frame: (A ⊕ B)' = A' ⊕
B').  A hypersparse output (``HyperMatrix``, ``HyperCscMatrix`` in the
transposed frame, ``SparseVec``) takes the pair-key merges of
:mod:`graphblas_tpu_torch.sparse.hyper` and ``hyper_accum_mask``, at any
dimension.  Ops over a user-defined type get and give dicts of tensors
on every container (the hypersparse ones too, where the JAX package
raises); a struct value meets a builtin domain with the cast rule's
``TypeError``.  The bitmap paths of ``eWiseAdd``, ``eWiseMult`` and
``apply`` are the span ``gb.engines.ewise``; over bitmap operands with
no pending tuples they read nothing back.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector
from ..core.ops import BinaryOp, SelectOp, UnaryOp
from ..core.types import cast, cast_result, tree_where
from ..utils import counters
from .containers import (require_builtin, require_container,
                         to_bitmap_operand, to_csr_operand, to_hyper_operand,
                         vec_hyper_operand)

__all__ = ["eWiseAdd", "eWiseMult", "apply", "select"]


def bitmap_operand(X, what: str):
    """A bitmap Vector as it is; any matrix container as a bitmap
    Matrix (pending tuples folded)."""
    return X.wait() if isinstance(X, Vector) else to_bitmap_operand(X, what)


def transposed(X, tran: bool):
    """A bitmap Matrix transposed when asked (a Vector as it is)."""
    if not tran or not isinstance(X, Matrix):
        return X
    return X.T()


def _ewise_T(op: BinaryOp, A, B, union: bool):
    if A.shape != B.shape:
        raise DimensionMismatch(f"eWise shapes {A.shape} vs {B.shape}")
    zt = op.ztype
    a = cast(A.values, op.xtype, A.type)
    b = cast(B.values, op.ytype, B.type)
    both = A.pattern & B.pattern
    zboth = cast_result(op(a, b), zt)
    if union:
        # entries in A only (or B only) are cast directly, no op applied
        za = cast(A.values, zt, A.type)
        zb = cast(B.values, zt, B.type)
        pat = A.pattern | B.pattern
        vals = tree_where(both, zboth, tree_where(A.pattern, za, zb))
    else:
        pat = both
        vals = zboth
    return type(A)(vals, pat, zt).canonical()


def csr_frame(C, A, tran: bool, M, what: str):
    """(Cw, Aw, Mw, csc): the CSR frame of a sparse output.  A
    ``CscMatrix`` C runs on its stored transpose, so its operands
    transpose with it (the reference's is_csc flag flip)."""
    from ..sparse.container import CscMatrix
    csc = isinstance(C, CscMatrix)
    Cw = (C.tr if csc else C).wait()
    Aw = to_csr_operand(A, csc ^ tran, f"{what} input")
    Mw = to_csr_operand(M, csc, "mask") if M is not None else None
    return Cw, Aw, Mw, csc


def finish_csr(Cw, Mw, T, accum, d, csc: bool):
    """The sparse epilogue in the CSR frame, re-wrapped as a CscMatrix
    when the output is one."""
    from ..sparse.container import CscMatrix
    from ..sparse.mask import csr_accum_mask
    out = csr_accum_mask(Cw, Mw, T, accum, d)
    return CscMatrix(out) if csc else out


def hyper_frame(C, M):
    """(Cw, operand, Mw, wrap): the by-row hypersparse frame of a
    hypersparse output, or None when C is not hypersparse.
    ``operand(X, tran, what)`` brings an input into the frame: a
    ``HyperCscMatrix`` C runs on its stored transpose, so its operands
    transpose with it; a ``SparseVec`` runs on its n x 1 matrix, its
    operands as vectors.  ``wrap`` re-wraps the result."""
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    from ..sparse.vector import SparseVec
    if isinstance(C, SparseVec):
        Mw = vec_hyper_operand(M, "mask") if M is not None else None
        return (C.hm.wait(), lambda X, tran, what: vec_hyper_operand(X, what),
                Mw, SparseVec)
    if isinstance(C, HyperCscMatrix):
        Mw = to_hyper_operand(M, True, "mask") if M is not None else None
        return (C.tr.wait(),
                lambda X, tran, what: to_hyper_operand(X, not tran, what),
                Mw, HyperCscMatrix)
    if isinstance(C, HyperMatrix):
        Mw = to_hyper_operand(M, False, "mask") if M is not None else None
        return C.wait(), to_hyper_operand, Mw, lambda X: X
    return None


def finish_hyper(Cw, Mw, T, accum, d, wrap):
    """The hypersparse epilogue in the by-row frame, re-wrapped."""
    from ..sparse.hyper import hyper_accum_mask
    return wrap(hyper_accum_mask(Cw, Mw, T, accum, replace=d.replace,
                                 complement=d.mask_scmp,
                                 structural=d.mask_structure))


def _dispatch_ewise(C, M, accum, op, A, B, d, union):
    from ..sparse.container import CscMatrix, CsrMatrix
    frame = hyper_frame(C, M)
    if frame is not None:
        from ..sparse.hyper import hyper_ewise
        Cw, operand, Mw, wrap = frame
        Aw = operand(A, d.tran0, "eWise input A")
        Bw = operand(B, d.tran1, "eWise input B")
        if Aw.shape != Cw.shape or Bw.shape != Cw.shape:
            raise DimensionMismatch(f"eWise shapes {Aw.shape}, {Bw.shape} "
                                    f"vs C {Cw.shape}")
        T = hyper_ewise(op, Aw, Bw, union=union)
        return finish_hyper(Cw, Mw, T, accum, d, wrap)
    if isinstance(C, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_ewise_add, csr_ewise_mult
        Cw, Aw, Mw, csc = csr_frame(C, A, d.tran0, M, "eWise A")
        Bw = to_csr_operand(B, csc ^ d.tran1, "eWise input B")
        if Aw.shape != Cw.shape or Bw.shape != Cw.shape:
            raise DimensionMismatch(f"eWise shapes {Aw.shape}, {Bw.shape} "
                                    f"vs C {C.shape}")
        T = (csr_ewise_add if union else csr_ewise_mult)(op, Aw, Bw)
        return finish_csr(Cw, Mw, T, accum, d, csc)
    with counters.span("gb.engines.ewise"):
        A = transposed(bitmap_operand(A, "eWise input A"), d.tran0)
        B = transposed(bitmap_operand(B, "eWise input B"), d.tran1)
        M = bitmap_operand(M, "mask") if M is not None else None
        T = _ewise_T(op, A, B, union=union)
        return accum_mask(C, M, T, accum, d)


def require_args(what, C, M, *inputs):
    """The typed container guard on an op's output, mask and inputs."""
    require_container(C, f"{what} output C")
    require_container(M, f"{what} mask", none_ok=True)
    for name, X in zip("AB", inputs):
        require_container(X, f"{what} input {name}")


def _ewise(what, C, M, accum, op, A, B, desc, union):
    require_args(what, C, M, A, B)
    d = desc_of(desc)
    from ..core.resolve import resolve_accum, resolve_binary
    op = resolve_binary(op, f"{what} op", None, A, B, C)
    accum = resolve_accum(accum, f"{what} accum", None, C, A)
    require_builtin(f"{what} op", op, accum)
    return _dispatch_ewise(C, M, accum, op, A, B, d, union)


@counters.counted("eWiseAdd")
def eWiseAdd(C, M, accum: Optional[BinaryOp], op: BinaryOp, A, B,
             desc: Optional[Descriptor] = None):
    """C<M> = accum(C, A+B): set-union merge (reference
    ``GrB_eWiseAdd``)."""
    return _ewise("eWiseAdd", C, M, accum, op, A, B, desc, union=True)


@counters.counted("eWiseMult")
def eWiseMult(C, M, accum: Optional[BinaryOp], op: BinaryOp, A, B,
              desc: Optional[Descriptor] = None):
    """C<M> = accum(C, A.*B): intersection merge (``GrB_eWiseMult``)."""
    return _ewise("eWiseMult", C, M, accum, op, A, B, desc, union=False)


@counters.counted("apply")
def apply(C, M, accum: Optional[BinaryOp], op: UnaryOp, A,
          desc: Optional[Descriptor] = None):
    """C<M> = accum(C, op(A)) (reference ``GrB_apply`` / ``GB_apply_op``):
    the pattern is reused as it is, only the values are mapped."""
    require_args("apply", C, M, A)
    from ..core.resolve import resolve_accum, resolve_unary
    op = resolve_unary(op, "apply op", None, A, C)
    accum = resolve_accum(accum, "apply accum", None, C, A)
    require_builtin("apply op", op, accum)
    d = desc_of(desc)
    frame = hyper_frame(C, M)
    if frame is not None:
        from ..sparse.hyper import hyper_apply
        Cw, operand, Mw, wrap = frame
        Aw = operand(A, d.tran0, "apply input")
        if Aw.shape != Cw.shape:
            raise DimensionMismatch(f"apply {Aw.shape} vs C {Cw.shape}")
        return finish_hyper(Cw, Mw, hyper_apply(op, Aw, ztype=op.ztype),
                            accum, d, wrap)
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(C, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_apply
        Cw, Aw, Mw, csc = csr_frame(C, A, d.tran0, M, "apply")
        if Aw.shape != Cw.shape:
            raise DimensionMismatch(f"apply {Aw.shape} vs C {C.shape}")
        return finish_csr(Cw, Mw, csr_apply(op, Aw), accum, d, csc)
    with counters.span("gb.engines.ewise"):
        A = transposed(bitmap_operand(A, "apply input"), d.tran0)
        M = bitmap_operand(M, "mask") if M is not None else None
        vals = cast_result(op(cast(A.values, op.xtype, A.type)), op.ztype)
        T = type(A)(vals, A.pattern, op.ztype).canonical()
        return accum_mask(C, M, T, accum, d)


def _index_grids(shape, device):
    if len(shape) == 1:
        i = torch.arange(shape[0], device=device)
        return i, torch.zeros_like(i)
    i = torch.arange(shape[0], device=device)[:, None].expand(shape)
    j = torch.arange(shape[1], device=device)[None, :].expand(shape)
    return i, j


@counters.counted("select")
def select(C, M, accum: Optional[BinaryOp], op: SelectOp, A,
           thunk: Any = 0, desc: Optional[Descriptor] = None):
    """C<M> = accum(C, select(A, thunk)) (reference ``GxB_select``)."""
    require_args("select", C, M, A)
    from ..core.resolve import resolve_accum, resolve_select
    op = resolve_select(op, "select op")
    accum = resolve_accum(accum, "select accum", None, C, A)
    require_builtin("select accum", accum)
    d = desc_of(desc)
    frame = hyper_frame(C, M)
    if frame is not None:
        from ..sparse.hyper import hyper_select
        from ..sparse.hyper_csc import HyperCscMatrix
        Cw, operand, Mw, wrap = frame
        Aw = operand(A, d.tran0, "select input")
        if Aw.shape != Cw.shape:
            raise DimensionMismatch(f"select {Aw.shape} vs C {Cw.shape}")
        # in the by-col (transposed) frame the predicate sees the
        # original coordinates: select_C'(i, j) = select_C(j, i)
        if isinstance(C, HyperCscMatrix):
            def fn(i, j, x):
                return op(j, i, x, thunk)
        else:
            def fn(i, j, x):
                return op(i, j, x, thunk)
        return finish_hyper(Cw, Mw, hyper_select("USER", Aw, user_fn=fn),
                            accum, d, wrap)
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(C, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_select
        Cw, Aw, Mw, csc = csr_frame(C, A, d.tran0, M, "select")
        if Aw.shape != Cw.shape:
            raise DimensionMismatch(f"select {Aw.shape} vs C {C.shape}")
        # in the by-col (transposed) frame the predicate sees swapped
        # coordinates: select_C'(i, j) = select_C(j, i)
        opw = SelectOp(op.name, lambda i, j, x, k: op(j, i, x, k)) \
            if csc else op
        return finish_csr(Cw, Mw, csr_select(opw, Aw, thunk), accum, d, csc)
    A = transposed(bitmap_operand(A, "select input"), d.tran0)
    M = bitmap_operand(M, "mask") if M is not None else None
    i, j = _index_grids(A.shape, A.device)
    keep = op(i, j, A.values, thunk)
    T = type(A)(A.values, A.pattern & keep, A.type).canonical()
    return accum_mask(C, M, T, accum, d)
