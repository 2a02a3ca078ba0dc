"""Typed resolution of operator arguments at the public API boundary.

Counterpart of ``graphblas_tpu/core/resolve.py``.

The reference checks every operator handle at API entry and returns
``GrB_NULL_POINTER`` / ``GrB_UNINITIALIZED_OBJECT`` with a message naming
the argument (``Source/GrB_mxm.c:30-60``: ``GB_RETURN_IF_NULL_OR_FAULTY
(semiring)``).  Pythonically the equivalent contract is: a public entry
point never lets a junk op/semiring/monoid argument reach a deep
AttributeError — it either resolves the argument (strings resolve
through the predefined catalogs, with the element type inferred from the
operands, so ``mxm(C, None, None, "plus_times", A, B)`` works) or raises
:class:`UnsupportedOp` naming the argument position.
"""

from __future__ import annotations

from typing import Optional

from .errors import GraphBLASError, Info
from .monoids import Monoid, monoid
from .ops import BinaryOp, SelectOp, UnaryOp, binary, select, unary
from .semirings import SEMIRINGS, Semiring, semiring
from .types import Type

__all__ = ["UnsupportedOp", "resolve_binary", "resolve_unary",
           "resolve_monoid", "resolve_semiring", "resolve_select",
           "resolve_accum", "operand_type"]


class UnsupportedOp(GraphBLASError):
    """An op/monoid/semiring argument that is neither a valid object nor
    a resolvable catalog name (reference ``GrB_UNINITIALIZED_OBJECT``)."""
    info = Info.UNINITIALIZED_OBJECT


def operand_type(*operands) -> Optional[Type]:
    """First usable element Type among the operands (for inferring the
    type family of a bare catalog name like ``"plus"``): the ``type`` of
    any container (CsrMatrix, CscMatrix, Matrix or Vector) that is not
    user-defined, as in the JAX package."""
    for x in operands:
        t = getattr(x, "type", None)
        if isinstance(t, Type) and not t.is_udt:
            return t
    return None


def _bad(arg: str, what: str, got) -> UnsupportedOp:
    name = type(got).__name__ if not isinstance(got, str) else repr(got)
    return UnsupportedOp(
        f"{arg}: expected {what} (object or catalog name), got {name}")


def _named_type(name: str) -> Optional[Type]:
    from .ops import _TYPES_BY_NAME
    base, _, tname = name.upper().rpartition("_")
    return _TYPES_BY_NAME.get(tname) if base else None


def resolve_binary(op, arg: str = "op", typ: Optional[Type] = None,
                   *operands) -> BinaryOp:
    """BinaryOp | Monoid (its op) | Semiring (its mult, per spec) |
    catalog name -> BinaryOp."""
    if isinstance(op, Semiring):
        op = op.mult
    if isinstance(op, Monoid):
        op = op.op
    if isinstance(op, BinaryOp):
        return op
    if isinstance(op, str):
        name = op.strip().lower()
        name = name.replace("grb_", "").replace("gxb_", "")
        t = typ or operand_type(*operands)
        try:
            if _named_type(name) is not None:
                from .ops import binary_op
                return binary_op(name)
            if t is None:
                raise KeyError(name)
            return binary[name][t]
        except (KeyError, AttributeError):
            hint = ("" if t is not None or _named_type(name) else
                    " (no typed operand to infer the type from; use a "
                    "typed name like 'plus_fp64')")
            raise _bad(arg, f"a binary op; {op!r} is not in the catalog"
                       + hint, op) from None
    raise _bad(arg, "a BinaryOp", op)


def resolve_unary(op, arg: str = "op", typ: Optional[Type] = None,
                  *operands) -> UnaryOp:
    """UnaryOp | catalog name -> UnaryOp."""
    if isinstance(op, UnaryOp):
        return op
    if isinstance(op, str):
        name = op.strip().lower().replace("grb_", "").replace("gxb_", "")
        t = typ or operand_type(*operands)
        try:
            if _named_type(name) is not None:
                from .ops import unary_op
                return unary_op(name)
            if t is None:
                raise KeyError(name)
            return unary[name][t]
        except (KeyError, AttributeError):
            raise _bad(arg, f"a unary op; {op!r} is not in the catalog",
                       op) from None
    raise _bad(arg, "a UnaryOp", op)


def resolve_monoid(op, arg: str = "op", typ: Optional[Type] = None,
                   *operands):
    """Monoid | BinaryOp (reduce accepts either, per spec) | catalog
    name -> Monoid or BinaryOp (callers that need strictly a Monoid
    check ``.identity``)."""
    if isinstance(op, (Monoid, BinaryOp)):
        return op
    if isinstance(op, Semiring):
        return op.add
    if isinstance(op, str):
        name = op.strip().lower().replace("grb_", "").replace("gxb_", "")
        name = name.replace("_monoid", "")
        t = typ or operand_type(*operands)
        tn = _named_type(name)
        try:
            if tn is not None:
                name = name.upper().rpartition("_")[0].lower()
                t = tn
            if t is None:
                raise KeyError(name)
            return monoid[name][t]
        except (KeyError, AttributeError):
            raise _bad(arg, f"a monoid; {op!r} is not in the catalog",
                       op) from None
    raise _bad(arg, "a Monoid", op)


def resolve_semiring(op, arg: str = "semiring",
                     typ: Optional[Type] = None, *operands) -> Semiring:
    if isinstance(op, Semiring):
        return op
    if isinstance(op, str):
        name = op.strip()
        key = ("GxB_" + name.upper().replace("GXB_", "")
               .replace("GRB_", ""))
        if key in SEMIRINGS:
            return SEMIRINGS[key]
        t = typ or operand_type(*operands)
        base = name.lower().replace("grb_", "").replace("gxb_", "")
        try:
            if t is None:
                raise KeyError(name)
            return semiring[base][t]
        except (KeyError, ValueError, AttributeError):
            hint = ("" if t is not None else
                    " (no typed operand to infer the type from; use a "
                    "typed name like 'plus_times_fp32')")
            raise _bad(arg, "a semiring; "
                       f"{op!r} is not in the catalog" + hint, op) from None
    raise _bad(arg, "a Semiring", op)


def resolve_select(op, arg: str = "op") -> SelectOp:
    """SelectOp | catalog name ("tril", "GxB_TRIU", ...) -> SelectOp."""
    if isinstance(op, SelectOp):
        return op
    if isinstance(op, str):
        name = op.strip().lower().replace("gxb_", "")
        try:
            return select[name]
        except (KeyError, AttributeError):
            raise _bad(arg, f"a select op; {op!r} is not in the catalog",
                       op) from None
    raise _bad(arg, "a SelectOp", op)


def resolve_accum(accum, arg: str = "accum",
                  typ: Optional[Type] = None, *operands):
    """None passes through (no accumulation); otherwise a BinaryOp."""
    if accum is None:
        return None
    if isinstance(accum, Monoid):
        return accum.op
    return resolve_binary(accum, arg, typ, *operands)
