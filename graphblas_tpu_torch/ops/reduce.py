"""Reductions: matrix -> vector (per-row monoid reduce) and -> scalar.

Counterpart of ``graphblas_tpu/ops/reduce.py``.  Reference:
``Source/GB_reduce_to_column.c`` (w<m> = accum(w, sum(A)) across rows)
and ``GB_reduce_to_scalar.c``.  A bitmap ``Matrix`` reduces with the
monoid's tensor reduction over its pattern; a ``CsrMatrix`` or
``CscMatrix`` through one segment reduce on the device
(:func:`graphblas_tpu_torch.sparse.ewise.csr_reduce_rows` /
``csr_reduce_scalar``), never densified.  A scalar crosses to the host
only at the end, as a numpy scalar of the monoid's type (a UINT64 sum
is unsigned).  A hypersparse input folds its present rows
(``hyper_reduce_vector``, a sparse vector over ``A.h``): into a
``SparseVec`` at any dimension, or scattered into a bitmap ``Vector``
(whose size bounds the rows); ``reduce_to_scalar`` takes every
container, ``SparseVec`` and the hypersparse ones included.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Vector
from ..core.monoids import Monoid
from ..core.ops import BinaryOp
from ..core.types import (cast, cast_result, cast_value, full_typed,
                          zeros_like_typed)
from ..utils.tree import tree_map
from ..utils import counters
from .containers import (UnsupportedContainer, require_builtin,
                         require_container, to_csr_operand, to_hyper_operand,
                         vec_hyper_operand)

__all__ = ["reduce_to_vector", "reduce_to_scalar", "reduce"]


def _as_monoid(op: Union[Monoid, BinaryOp], *operands) -> Monoid:
    from ..core.resolve import UnsupportedOp, resolve_monoid
    op = resolve_monoid(op, "reduce op", None, *operands)
    require_builtin("reduce op", op)
    if isinstance(op, Monoid):
        return op
    # a bare associative binary op: look up the matching built-in monoid
    from ..core.monoids import monoid as monoid_ns
    try:
        return monoid_ns[op.name.lower()][op.ztype]
    except (KeyError, AttributeError):
        raise UnsupportedOp(
            f"reduce op: {op.name} has no matching built-in monoid; "
            "pass a Monoid (monoid_new) instead") from None


@counters.counted("reduce_to_vector")
def reduce_to_vector(w: Vector, m: Optional[Vector],
                     accum: Optional[BinaryOp],
                     op: Union[Monoid, BinaryOp], A,
                     desc: Optional[Descriptor] = None) -> Vector:
    """w<m> = accum(w, reduce-rows(A)); TRAN0 reduces columns instead."""
    require_container(w, "reduce output w")
    require_container(m, "reduce mask", none_ok=True)
    require_container(A, "reduce input A")
    from ..sparse.vector import SparseVec
    if not isinstance(w, (Vector, SparseVec)) \
            or isinstance(A, (Vector, SparseVec)):
        raise UnsupportedContainer(
            f"reduce_to_vector: a Vector or SparseVec output and a matrix "
            f"input, got {type(w).__name__} and {type(A).__name__}")
    d = desc_of(desc)
    from ..core.resolve import resolve_accum
    accum = resolve_accum(accum, "reduce accum", None, w, A)
    require_builtin("reduce accum", accum)
    mon = _as_monoid(op, A, w)
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix, hyper_reduce_vector
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(w, SparseVec):
        # sparse output at any dimension: the per-row fold is sparse over
        # A.h already; the epilogue runs on the wrapped n x 1 matrix
        from ..sparse.hyper import hyper_accum_mask
        Ah = to_hyper_operand(A, d.tran0, "reduce input")
        if Ah.nrows != w.size:
            raise DimensionMismatch(
                f"w has size {w.size}, A has {Ah.nrows} rows")
        ids, vals = hyper_reduce_vector(mon, Ah)
        T = SparseVec.from_coo(ids, vals, w.size, type=mon.type, dup=None,
                               device=Ah.device).hm
        mh = vec_hyper_operand(m, "mask") if m is not None else None
        return SparseVec(hyper_accum_mask(
            w.hm, mh, T, accum, replace=d.replace, complement=d.mask_scmp,
            structural=d.mask_structure))
    if isinstance(A, (HyperMatrix, HyperCscMatrix)):
        # the present-row fold scattered into the bitmap w (a by-column
        # A reduces its stored transpose's columns)
        Ah = to_hyper_operand(A, d.tran0, "reduce input")
        if Ah.nrows != w.size:
            raise DimensionMismatch(
                f"w has size {w.size}, A has {Ah.nrows} rows")
        ids, vals = hyper_reduce_vector(mon, Ah)
        return accum_mask(w, m, _scatter_vector(ids, vals, w.size, mon.type,
                                                w.device), accum, d)
    if isinstance(A, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_reduce_rows
        A = to_csr_operand(A, d.tran0, "reduce input")
        if A.nrows != w.size:
            raise DimensionMismatch(
                f"w has size {w.size}, A has {A.nrows} rows")
        red, tpat = csr_reduce_rows(mon, A)
        return accum_mask(w, m, Vector(red, tpat, mon.type), accum, d)
    A = A.wait()
    vals, pat = A.values, A.pattern
    if d.tran0:
        vals, pat = tree_map(lambda v: v.T, vals), pat.T
    if pat.shape[0] != w.size:
        raise DimensionMismatch(
            f"w has size {w.size}, A has {pat.shape[0]} rows")
    red = mon.reduce(cast(vals, mon.type, A.type), axis=1, where=pat)
    T = Vector(red, pat.any(dim=1), mon.type).canonical()
    return accum_mask(w, m, T, accum, d)


def _scatter_vector(ids, vals, n: int, t, device) -> Vector:
    """A bitmap Vector of size ``n`` holding ``vals`` (host or device;
    a dict for a struct type) at the distinct indices ``ids``."""
    idx = torch.as_tensor(np.asarray(ids, np.int64), device=device)
    pat = torch.zeros(n, dtype=torch.bool, device=device)
    pat[idx] = True
    out = zeros_like_typed(n, t, device)

    def put(o, v):
        v = torch.as_tensor(v).to(device)
        o[idx] = v.to(o.dtype)
    if t.is_udt:
        tree_map(put, out, vals)
        return Vector(out, pat, t)
    return Vector.from_coo(ids, vals, n, type=t, device=device)


def _accum_scalar(accum: BinaryOp, c, t):
    """accum(c, t) on host scalars, through the op itself; a numpy
    scalar of its ztype."""
    from ..sparse.ewise import host_value

    def arg(v, typ):
        return full_typed((), cast_value(v, typ), typ, "cpu")
    z = cast_result(accum(arg(c, accum.xtype), arg(t, accum.ytype)),
                    accum.ztype)
    return host_value(z.reshape(1).numpy(), accum.ztype)


@counters.counted("reduce_to_scalar")
def reduce_to_scalar(accum: Optional[BinaryOp], op: Union[Monoid, BinaryOp],
                     A, c: Any = None):
    """c = accum(c, reduce-all(A)); returns a host scalar of the
    monoid's type.  An empty A reduces to the monoid identity
    (``GB_reduce_to_scalar.c:35``)."""
    require_container(A, "reduce input A")
    from ..core.resolve import resolve_accum
    accum = resolve_accum(accum, "reduce accum", None, A)
    require_builtin("reduce accum", accum)
    mon = _as_monoid(op, A)
    A = A.wait()
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix, hyper_reduce_scalar
    from ..sparse.hyper_csc import HyperCscMatrix
    from ..sparse.vector import SparseVec
    if isinstance(A, SparseVec):
        A = A.hm
    if isinstance(A, HyperCscMatrix):
        A = A.tr               # reduce-all is orientation-invariant
    if isinstance(A, HyperMatrix):
        t = hyper_reduce_scalar(mon, A) if A.nvals else mon.identity
    elif isinstance(A, (CsrMatrix, CscMatrix)):
        from ..sparse.ewise import csr_reduce_scalar
        # reduce-all is orientation-invariant: a CSC reduces its arrays
        t = csr_reduce_scalar(mon, A.tr if isinstance(A, CscMatrix) else A)
    else:
        from ..sparse.ewise import host_scalar
        vals = cast(A.values, mon.type, A.type)
        r = mon.reduce(vals, where=A.pattern)
        if isinstance(A, Vector) and not mon.type.is_udt:
            # the same read learns whether every entry is present, which
            # a product with this vector asks next in a frontier loop
            t, full = host_scalar(r, mon.type, A.pattern.all())
            A._full = (A.pattern._version, full)
        else:
            t = host_scalar(r, mon.type)
    if accum is not None and c is not None:
        t = _accum_scalar(accum, c, t)
    return t


def reduce(*args, **kw):
    """Polymorphic GrB_reduce: dispatches on the output, as the C
    API's _Generic macro does."""
    if isinstance(args[0], Vector):
        return reduce_to_vector(*args, **kw)
    return reduce_to_scalar(*args, **kw)
