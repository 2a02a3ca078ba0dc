"""GraphBLAS operators: unary, binary and select ops over torch tensors.

Counterpart of ``graphblas_tpu/core/ops.py``: an operator is a function
of tensors in its types' storage dtypes plus type metadata.  Integer
division follows the reference's MATLAB-style semantics
(``Source/GB.h:2769-2900``): x/0 is 0 for x==0, +/-"infinity" (type
max/min) otherwise; INT_MIN / -1 wraps; bool division z = x.

Unsigned types live in signed storage (:mod:`types`), so MIN, MAX, DIV
and the ordered comparisons read UINT values through
:func:`types.ordered`; PLUS, MINUS, TIMES and AINV wrap identically on
either reading of the bits.  Integer MINV is the reference's 1/x with
x/0 the type's maximum.

User-defined operators (reference ``GrB_UnaryOp_new``,
``GrB_BinaryOp_new``, ``GxB_SelectOp_new``) are made by calling
:class:`UnaryOp`, :class:`BinaryOp` or :class:`SelectOp` with a function
of torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .types import (BOOL, BUILTIN_TYPES, FC32, FC64, Type, cast, ordered,
                    type_by_name)

__all__ = ["UnaryOp", "BinaryOp", "SelectOp", "unary", "binary", "select",
           "binary_op", "unary_op"]


@dataclasses.dataclass(frozen=True)
class UnaryOp:
    """z = f(x).  Reference: ``GrB_UnaryOp`` (GraphBLAS.h:598+)."""
    name: str
    fn: Callable  # fn(x) -> z, tensors of xtype -> ztype storage
    ztype: Type
    xtype: Type

    def __call__(self, x):
        return self.fn(x)

    def __repr__(self):  # pragma: no cover
        return f"UnaryOp({self.name}_{self.xtype.name})"


@dataclasses.dataclass(frozen=True)
class BinaryOp:
    """z = f(x, y).  Reference: ``GrB_BinaryOp`` (GraphBLAS.h:790+)."""
    name: str
    fn: Callable  # fn(x, y) -> z
    ztype: Type
    xtype: Type
    ytype: Type

    def __call__(self, x, y):
        return self.fn(x, y)

    def __repr__(self):  # pragma: no cover
        return f"BinaryOp({self.name}_{self.xtype.name})"


@dataclasses.dataclass(frozen=True)
class SelectOp:
    """keep = f(i, j, x, thunk), elementwise over the pattern: ``i``,
    ``j`` integer index tensors, ``x`` the values in storage form.

    Reference: ``GxB_SelectOp`` (GB.h:625-649), ``GxB_TRIL`` etc.
    """
    name: str
    fn: Callable  # fn(i, j, x, k) -> bool tensor

    def __call__(self, i, j, x, k):
        return self.fn(i, j, x, k)


def _t(x, t: Type) -> torch.Tensor:
    """x as a tensor of t's storage (Python scalars included)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == t.storage else x.to(t.storage)
    return torch.as_tensor(t.storage_scalar(x), dtype=t.storage)


# ---------------------------------------------------------------------------
# complex PLUS/MINUS, and the complex order (torch has no <, >, minimum or
# maximum on complex tensors)
# ---------------------------------------------------------------------------

def _cx_parts_op(t: Type, fn):
    """PLUS (MINUS) of complex values, part by part on the real view.
    torch's complex ``add``/``sub`` scale the second operand by a complex
    ``alpha``, so ``0 + infj`` gives ``nan+infj`` where the JAX package
    gives ``infj`` (``test_torch_complex.py::test_binary_family_exact``,
    the plus, minus and rminus cases)."""
    def op(x, y):
        x, y = _t(x, t), _t(y, t)
        return torch.view_as_complex(fn(torch.view_as_real(x),
                                        torch.view_as_real(y)))
    return op


def _cx_isnan(x: torch.Tensor) -> torch.Tensor:
    return torch.isnan(x.real) | torch.isnan(x.imag)


def cx_less(x: torch.Tensor, y: torch.Tensor,
            or_equal: bool = False) -> torch.Tensor:
    """Lexicographic x < y (x <= y) of complex tensors: the real parts,
    then the imaginary parts; false wherever a NaN meets the test."""
    a, b, c, d = x.real, x.imag, y.real, y.imag
    tail = (b <= d) if or_equal else (b < d)
    return (a < c) | ((a == c) & tail)


def cx_extreme(x: torch.Tensor, name: str, ident: torch.Tensor, red,
               spread) -> torch.Tensor:
    """The complex MIN (MAX) monoid's fold, lexicographic and from the
    identity, a NaN term dropping out: the extreme real part, then the
    extreme imaginary part among the terms (the identity included) that
    hold it.  ``red(v, how)`` folds a real tensor shaped like ``x`` with
    ``torch.amin``/``amax`` (``how``: "amin"/"amax") into the result's
    slots; ``spread(r)`` lays a slot tensor back over ``x``'s terms.
    The monoid reduce (along an axis) and the segment reduce (by
    ``scatter_reduce``) both fold through this."""
    top = name == "MAX"
    how = "amax" if top else "amin"
    fill = float("-inf") if top else float("inf")
    x = torch.where(_cx_isnan(x), ident, x)
    re = red(x.real.contiguous(), how)
    im = red(torch.where(x.real == spread(re), x.imag, fill), how)
    # the identity holds the best real part too where it ties
    held = re == ident.real
    im = torch.where(held, (torch.maximum if top else torch.minimum)(
        im, ident.imag), im)
    return torch.complex(re, im).to(x.dtype)


def _cx_pick(t: Type, take_x_if_less: bool):
    """MIN (MAX): the lexicographically smaller (larger) operand, a NaN
    operand dropping out."""
    def fn(x, y):
        x, y = torch.broadcast_tensors(_t(x, t), _t(y, t))
        better = cx_less(x, y) if take_x_if_less else cx_less(y, x)
        z = torch.where(better, x, y)
        z = torch.where(_cx_isnan(y), x, z)
        return torch.where(_cx_isnan(x), y, z)
    return fn


# ---------------------------------------------------------------------------
# MATLAB-style integer division (reference GB.h:2769-2900)
# ---------------------------------------------------------------------------

def _udiv64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit quotient of int64 bit patterns (y != 0): halve x
    so the signed division is exact, then correct by one."""
    big = y < 0                       # y >= 2^63: quotient is 0 or 1
    ys = torch.where(big, 1, y)
    half = (x >> 1) & torch.iinfo(torch.int64).max
    q = torch.div(half, ys, rounding_mode="trunc") << 1
    r = x - q * ys
    q = q + (ordered(r, _U64) >= ordered(ys, _U64)).to(torch.int64)
    return torch.where(big, (ordered(x, _U64) >= ordered(y, _U64))
                       .to(torch.int64), q)


def _idiv(t: Type):
    info = np.iinfo(t.dtype)
    tmin, tmax = t.storage_scalar(info.min), t.storage_scalar(info.max)
    if t.is_signed:
        def div(x, y):
            x, y = _t(x, t), _t(y, t)
            safe_y = torch.where((y == 0) | (y == -1), 1, y).to(t.storage)
            q = torch.div(x, safe_y, rounding_mode="trunc")
            div0 = torch.where(x == 0, 0, torch.where(x < 0, tmin, tmax))
            return torch.where(y == 0, div0.to(t.storage),
                               torch.where(y == -1, -x, q)).to(t.storage)
        return div

    def udiv(x, y):
        x, y = _t(x, t), _t(y, t)
        zero = y == 0
        if t.nbits < 64:
            xv, yv = ordered(x, t), ordered(y, t)
            q = torch.div(xv, torch.where(zero, 1, yv),
                          rounding_mode="trunc").to(t.storage)
        else:
            q = _udiv64(x, torch.where(zero, 1, y))
        div0 = torch.where(x == 0, 0, tmax).to(t.storage)
        return torch.where(zero, div0, q).to(t.storage)
    return udiv


def _iminv(t: Type):
    """Integer 1/x, truncated: 1 at x = 1, -1 at x = -1 (signed), 0
    otherwise, and the type's maximum at x = 0 (MATLAB's 1/0)."""
    tmax = t.storage_scalar(np.iinfo(t.dtype).max)

    def minv(x):
        x = _t(x, t)
        q = (x == 1).to(t.storage)
        if t.is_signed:
            q = torch.where(x == -1, -1, q).to(t.storage)
        return torch.where(x == 0, tmax, q).to(t.storage)
    return minv


# ---------------------------------------------------------------------------
# families: op name -> per-type concrete op
# ---------------------------------------------------------------------------

class _Family:
    """A named operator family, indexed by type: ``binary.plus[FP64]``."""

    def __init__(self, name: str, make: Callable[[Type], object]):
        self.name = name
        self._make = make
        self._cache: Dict[str, object] = {}

    def __getitem__(self, t: Type):
        op = self._cache.get(t.name)
        if op is None:
            op = self._make(t)
            self._cache[t.name] = op
        return op

    def __repr__(self):  # pragma: no cover
        return f"OpFamily({self.name})"


def _unary_family(name: str, fn_of_t) -> _Family:
    def make(t: Type) -> UnaryOp:
        return UnaryOp(name, fn_of_t(t), t, t)
    return _Family(name, make)


def _binary_family(name: str, fn_of_t, ztype_of_t=lambda t: t) -> _Family:
    def make(t: Type) -> BinaryOp:
        return BinaryOp(name, fn_of_t(t), ztype_of_t(t), t, t)
    return _Family(name, make)


class _Namespace:
    def __init__(self, **families):
        self.__dict__.update(families)
        self._all = families

    def __getitem__(self, name):
        return self._all[name.lower()]

    def names(self):
        return list(self._all)


# ---- unary ops (reference GB_ops_template.h: IDENTITY AINV MINV LNOT ONE ABS)

def _u_identity(t):
    return lambda x: x


def _u_ainv(t):
    if t.is_bool:
        return lambda x: x
    return lambda x: (-_t(x, t)).to(t.storage)


def _u_minv(t):
    if t.is_bool:
        return lambda x: torch.ones_like(_t(x, t))
    if t.is_integer:
        return _iminv(t)
    # a tensor numerator: torch's scalar 1 / 0j is nan+nanj, 1s / 0j the
    # JAX package's inf+nanj
    return lambda x: (torch.ones_like(_t(x, t)) / _t(x, t)).to(t.storage)


def _u_lnot(t):
    return lambda x: cast(~(_t(x, t) != 0), t, BOOL)


def _u_one(t):
    return lambda x: torch.ones_like(_t(x, t))


def _u_abs(t):
    if t.is_bool or t.is_unsigned:
        return lambda x: x
    return lambda x: torch.abs(_t(x, t)).to(t.storage)


unary = _Namespace(
    identity=_unary_family("IDENTITY", _u_identity),
    ainv=_unary_family("AINV", _u_ainv),
    minv=_unary_family("MINV", _u_minv),
    lnot=_unary_family("LNOT", _u_lnot),
    one=_unary_family("ONE", _u_one),
    abs=_unary_family("ABS", _u_abs),
)


# ---- binary ops -----------------------------------------------------------

def _b_first(t):
    return lambda x, y: x


def _b_second(t):
    return lambda x, y: y


def _b_pair(t):
    def pair(x, y):
        x, y = _t(x, t), _t(y, t)
        return torch.ones(torch.broadcast_shapes(x.shape, y.shape),
                          dtype=t.storage, device=x.device)
    return pair


def _ordered_pick(t, take_x):
    """MIN/MAX of integer types: pick by the type's own order."""
    def fn(x, y):
        x, y = _t(x, t), _t(y, t)
        return torch.where(take_x(ordered(x, t), ordered(y, t)), x, y)
    return fn


def _b_min(t):
    if t.is_bool:
        return lambda x, y: x & y
    if t.is_complex:
        return _cx_pick(t, True)
    if t.is_float:
        # the reference's fminf semantics: a NaN operand is ignored
        return lambda x, y: torch.fmin(_t(x, t), _t(y, t))
    return _ordered_pick(t, lambda a, b: a <= b)


def _b_max(t):
    if t.is_bool:
        return lambda x, y: x | y
    if t.is_complex:
        return _cx_pick(t, False)
    if t.is_float:
        return lambda x, y: torch.fmax(_t(x, t), _t(y, t))
    return _ordered_pick(t, lambda a, b: a >= b)


def _b_plus(t):
    if t.is_bool:
        return lambda x, y: x | y
    if t.is_complex:
        return _cx_parts_op(t, torch.add)
    return lambda x, y: (_t(x, t) + _t(y, t)).to(t.storage)


def _b_minus(t):
    if t.is_bool:
        return lambda x, y: x ^ y
    if t.is_complex:
        return _cx_parts_op(t, torch.sub)
    return lambda x, y: (_t(x, t) - _t(y, t)).to(t.storage)


def _b_rminus(t):
    if t.is_bool:
        return lambda x, y: x ^ y
    if t.is_complex:
        f = _cx_parts_op(t, torch.sub)
        return lambda x, y: f(y, x)
    return lambda x, y: (_t(y, t) - _t(x, t)).to(t.storage)


def _b_times(t):
    if t.is_bool:
        return lambda x, y: x & y
    return lambda x, y: (_t(x, t) * _t(y, t)).to(t.storage)


def _b_div(t):
    if t.is_bool:
        return lambda x, y: x  # bool div == first (GB.h:2889-2900)
    if t.is_integer:
        return _idiv(t)
    return lambda x, y: (_t(x, t) / _t(y, t)).to(t.storage)


def _b_rdiv(t):
    f = _b_div(t)
    if t.is_bool:
        return lambda x, y: y
    return lambda x, y: f(y, x)


_CX_CMP = {">": lambda x, y: cx_less(y, x),
           "<": lambda x, y: cx_less(x, y),
           ">=": lambda x, y: cx_less(y, x, True),
           "<=": lambda x, y: cx_less(x, y, True)}


def _cmp(fn, order=None):
    """Comparison over t's own order (unsigned read as unsigned; complex
    lexicographic for the ordered comparisons)."""
    def of_t(t):
        if t.is_complex and order is not None:
            cx = _CX_CMP[order]
            return lambda x, y: cx(*torch.broadcast_tensors(_t(x, t),
                                                            _t(y, t)))
        return lambda x, y: fn(ordered(_t(x, t), t), ordered(_t(y, t), t))
    return of_t


def _is_of(fn, order=None):
    """IS* ops: a comparison returned in the operand type (0/1)."""
    cmp = _cmp(fn, order)

    def of_t(t):
        c = cmp(t)
        return lambda x, y: cast(c(x, y), t, BOOL)
    return of_t


def _logical(fn):
    def of_t(t):
        return lambda x, y: cast(fn(_t(x, t) != 0, _t(y, t) != 0), t, BOOL)
    return of_t


def _b_any(t):
    # GxB_ANY: either operand; the JAX package picks the second
    return lambda x, y: y


binary = _Namespace(
    first=_binary_family("FIRST", _b_first),
    second=_binary_family("SECOND", _b_second),
    pair=_binary_family("PAIR", _b_pair),
    any=_binary_family("ANY", _b_any),
    min=_binary_family("MIN", _b_min),
    max=_binary_family("MAX", _b_max),
    plus=_binary_family("PLUS", _b_plus),
    minus=_binary_family("MINUS", _b_minus),
    rminus=_binary_family("RMINUS", _b_rminus),
    times=_binary_family("TIMES", _b_times),
    div=_binary_family("DIV", _b_div),
    rdiv=_binary_family("RDIV", _b_rdiv),
    iseq=_binary_family("ISEQ", _is_of(lambda x, y: x == y)),
    isne=_binary_family("ISNE", _is_of(lambda x, y: x != y)),
    isgt=_binary_family("ISGT", _is_of(lambda x, y: x > y, ">")),
    islt=_binary_family("ISLT", _is_of(lambda x, y: x < y, "<")),
    isge=_binary_family("ISGE", _is_of(lambda x, y: x >= y, ">=")),
    isle=_binary_family("ISLE", _is_of(lambda x, y: x <= y, "<=")),
    lor=_binary_family("LOR", _logical(lambda x, y: x | y)),
    land=_binary_family("LAND", _logical(lambda x, y: x & y)),
    lxor=_binary_family("LXOR", _logical(lambda x, y: x ^ y)),
    eq=_binary_family("EQ", _cmp(lambda x, y: x == y), lambda t: BOOL),
    ne=_binary_family("NE", _cmp(lambda x, y: x != y), lambda t: BOOL),
    gt=_binary_family("GT", _cmp(lambda x, y: x > y, ">"), lambda t: BOOL),
    lt=_binary_family("LT", _cmp(lambda x, y: x < y, "<"), lambda t: BOOL),
    ge=_binary_family("GE", _cmp(lambda x, y: x >= y, ">="),
                      lambda t: BOOL),
    le=_binary_family("LE", _cmp(lambda x, y: x <= y, "<="),
                      lambda t: BOOL),
)

_U64 = type_by_name("UINT64")


# ---- select ops (GxB_TRIL/TRIU/DIAG/OFFDIAG/NONZERO + user) ----------------

select = _Namespace(
    tril=SelectOp("TRIL", lambda i, j, x, k: (j - i) <= k),
    triu=SelectOp("TRIU", lambda i, j, x, k: (j - i) >= k),
    diag=SelectOp("DIAG", lambda i, j, x, k: (j - i) == k),
    offdiag=SelectOp("OFFDIAG", lambda i, j, x, k: (j - i) != k),
    nonzero=SelectOp("NONZERO", lambda i, j, x, k: x != 0),
)

# ---- typed-name lookup: e.g. binary_op("PLUS", FP64), "GrB_PLUS_FP64" ------

_TYPES_BY_NAME = {t.name: t for t in BUILTIN_TYPES + (FC32, FC64)}


def binary_op(name: str, typ: Optional[Type] = None) -> BinaryOp:
    """Look up a binary op by GraphBLAS-style name, e.g. ``PLUS_FP64``."""
    name = name.upper().replace("GRB_", "").replace("GXB_", "")
    if typ is None:
        base, _, tname = name.rpartition("_")
        typ = _TYPES_BY_NAME[tname]
        name = base
    return binary[name.lower()][typ]


def unary_op(name: str, typ: Optional[Type] = None) -> UnaryOp:
    """Look up a unary op by GraphBLAS-style name, e.g. ``AINV_INT32``."""
    name = name.upper().replace("GRB_", "").replace("GXB_", "")
    if typ is None:
        base, _, tname = name.rpartition("_")
        typ = _TYPES_BY_NAME[tname]
        name = base
    return unary[name.lower()][typ]
