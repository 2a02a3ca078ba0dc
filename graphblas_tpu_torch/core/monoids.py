"""Monoids: an associative binary op + identity (+ optional terminal).

Counterpart of ``graphblas_tpu/core/monoids.py``.  Reference:
``Source/GB_Monoid_new.c``, ``GxB_Monoid_terminal_new.c`` and the 44
predefined monoids in ``Include/GraphBLAS.h:5100-5162``.

An identity or terminal is a host scalar of the GraphBLAS type (a numpy
scalar, so UINT identities keep their unsigned value, equal to the JAX
package's; a dict of the fields' identities for a user-defined type);
:meth:`Monoid.identity_array` puts it in storage form on a device.

A user-defined monoid folds by its op: :meth:`Monoid.reduce` runs the
log-depth pairwise fold over the struct's leaves, as the JAX package's
``_pairwise_reduce`` does over its pytrees.  Complex monoids: PLUS is
``torch.sum``, TIMES folds by the op, and MIN/MAX take the
lexicographic extreme from the identity with NaN terms dropped (the
identities are ``+inf+0j`` and ``-inf+0j``; the segment reduce folds
through the same :func:`ops.cx_extreme`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map
from .ops import BinaryOp, binary, cx_extreme
from .types import (BOOL, BUILTIN_TYPES, Type, from_ordered, full_typed,
                    ordered, tree_where)

__all__ = ["Monoid", "monoid", "monoid_new", "MONOIDS"]


@dataclasses.dataclass(frozen=True)
class Monoid:
    op: BinaryOp
    identity: Any
    terminal: Optional[Any] = None

    @property
    def type(self) -> Type:
        return self.op.ztype

    @property
    def name(self) -> str:
        return f"{self.op.name}_{self.type.name}_MONOID"

    def __call__(self, x, y):
        return self.op(x, y)

    def identity_value(self):
        """The identity as a Python number of the storage dtype (a dict
        of them for a user-defined type)."""
        return storage_value(self.identity, self.type)

    def identity_array(self, shape=(), device="cpu"):
        return full_typed(shape, self.identity, self.type, device)

    def reduce(self, x: torch.Tensor, axis=None, where=None):
        """Reduce a tensor with this monoid along ``axis`` (all axes when
        None).  ``where`` masks out absent entries (they contribute the
        identity).  Exact torch reductions for the standard monoids, a
        log-depth pairwise fold otherwise.  LOR and LAND fold by the op
        on every type: 1 where any (LOR) or every (LAND) term is
        nonzero, 0 otherwise, in the monoid's type (the reference's
        ``(x != 0) || (y != 0)``; the JAX package takes a max/min of
        the values over non-bool types)."""
        nm = self.op.name
        t = self.type
        dev = tree_leaves(x)[0].device
        if where is not None:
            x = tree_where(where, x, self.identity_array((), dev))
        if axis is None:
            x = tree_map(lambda v: v.reshape(-1), x)
            axis = 0
        if t.is_udt:
            return _pairwise_reduce(self.op, x, axis, self.identity, t)
        if t.is_complex and nm in ("MIN", "MAX"):
            return _cx_minmax(x, axis, nm, self.identity_array((), dev))
        if nm == "PLUS" and not t.is_bool:
            return torch.sum(x, dim=axis, dtype=x.dtype)
        if nm == "TIMES" and not t.is_bool and not t.is_complex:
            return torch.prod(x, dim=axis, dtype=x.dtype)
        if nm == "MIN" or (nm in ("LAND", "TIMES") and t.is_bool):
            return _minmax(x, axis, t, "min")
        if nm == "MAX" or (nm in ("LOR", "PLUS") and t.is_bool):
            return _minmax(x, axis, t, "max")
        if nm in ("LOR", "LAND"):
            # the op's own fold from the identity on a non-bool type: 1
            # where any (LOR) or every (LAND) term is nonzero, else 0
            nz = x != 0
            r = nz.any(dim=axis) if nm == "LOR" else nz.all(dim=axis)
            return r.to(x.dtype)
        if nm in ("LXOR", "MINUS") and t.is_bool:
            return x.to(torch.int32).sum(dim=axis) % 2 != 0
        if nm == "LXOR":
            return ((x != 0).to(torch.int32).sum(dim=axis) % 2 != 0
                    ).to(x.dtype)
        if nm == "EQ":
            # EQ monoid = XNOR: identity true
            return (~(x != 0)).to(torch.int32).sum(dim=axis) % 2 == 0
        return _pairwise_reduce(self.op, x, axis, self.identity, t)

    def __repr__(self):  # pragma: no cover
        return f"Monoid({self.name})"


def _minmax(x: torch.Tensor, axis: int, t: Type, which: str):
    """MIN/MAX reduction: NaN-ignoring on floats (fmin/fmax, like the
    reference's fminf-based monoids), the type's own order on integers,
    all/any on bool.  An empty axis gives the identity."""
    if t.is_bool:
        return x.all(dim=axis) if which == "min" else x.any(dim=axis)
    if t.is_float:
        fill = np.inf if which == "min" else -np.inf
        v = torch.where(torch.isnan(x), fill, x)
        r = (torch.amin if which == "min" else torch.amax)(v, dim=axis)
        # an all-NaN slice reduces to NaN, as numpy's nanmin does
        return torch.where(torch.isnan(x).all(dim=axis), torch.nan, r)
    k = ordered(x, t)
    r = (torch.amin if which == "min" else torch.amax)(k, dim=axis)
    return from_ordered(r, t)


def storage_value(value, t: Type):
    """A host scalar of ``t`` in storage form (a dict for a struct)."""
    if t.is_udt:
        return {k: storage_value(value[k], ft) for k, ft in t.fields}
    return t.storage_scalar(value)


def _cx_minmax(x: torch.Tensor, axis: int, nm: str, ident: torch.Tensor):
    """Lexicographic MIN/MAX of complex values along ``axis``, from the
    identity with NaN terms dropped (:func:`ops.cx_extreme`)."""
    if x.shape[axis] == 0:
        return ident.expand(x.shape[:axis] + x.shape[axis + 1:]).clone()
    return cx_extreme(x, nm, ident,
                      lambda v, how: getattr(torch, how)(v, dim=axis),
                      lambda r: r.unsqueeze(axis))


def _pairwise_reduce(op: BinaryOp, x, axis: int, identity, t: Type):
    """Log-depth associative fold along ``axis`` (over every leaf of a
    struct value alike); an empty axis gives the identity."""
    x = tree_map(lambda v: torch.movedim(v, axis, 0), x)
    n = tree_leaves(x)[0].shape[0]
    while n > 1:
        half = n // 2
        merged = op(tree_map(lambda v: v[:half], x),
                    tree_map(lambda v: v[half:2 * half], x))
        if n % 2:
            merged = tree_map(lambda mm, v: torch.cat(
                [mm, v[2 * half:2 * half + 1]], dim=0), merged, x)
        x = merged
        n = tree_leaves(x)[0].shape[0]
    if n == 0:
        lead = tree_leaves(x)[0]
        return full_typed(lead.shape[1:], identity, t, lead.device)
    return tree_map(lambda v: v[0], x)


class _MonoidFamily:
    def __init__(self, opfam, identity_of, terminal_of=lambda t: None):
        self._opfam = opfam
        self._identity_of = identity_of
        self._terminal_of = terminal_of
        self._cache = {}

    def __getitem__(self, t: Type) -> Monoid:
        m = self._cache.get(t.name)
        if m is None:
            m = Monoid(self._opfam[t], self._identity_of(t),
                       self._terminal_of(t))
            self._cache[t.name] = m
        return m


def monoid_new(op: BinaryOp, identity, terminal=None) -> Monoid:
    """User monoid constructor (reference ``GrB_Monoid_new``)."""
    return Monoid(op, identity, terminal)


class _Namespace:
    def __init__(self, **fams):
        self.__dict__.update(fams)
        self._all = fams

    def __getitem__(self, name):
        return self._all[name.lower()]


monoid = _Namespace(
    min=_MonoidFamily(binary.min, lambda t: t.max_value(),
                      lambda t: t.min_value() if t.is_integer or t.is_bool
                      else -np.inf),
    max=_MonoidFamily(binary.max, lambda t: t.min_value(),
                      lambda t: t.max_value() if t.is_integer or t.is_bool
                      else np.inf),
    plus=_MonoidFamily(binary.plus, lambda t: t.zero()),
    times=_MonoidFamily(binary.times,
                        lambda t: True if t.is_bool
                        else np.asarray(1, t.dtype)[()],
                        lambda t: np.asarray(0, t.dtype)[()]
                        if t.is_integer else None),
    lor=_MonoidFamily(binary.lor, lambda t: False, lambda t: True),
    land=_MonoidFamily(binary.land, lambda t: True, lambda t: False),
    lxor=_MonoidFamily(binary.lxor, lambda t: False),
    eq=_MonoidFamily(binary.eq, lambda t: True),
)

# The reference's 44 predefined monoids: MIN/MAX/PLUS/TIMES x 10 non-bool
# types + LOR/LAND/LXOR/EQ on BOOL (Include/GraphBLAS.h:5100-5162).
MONOIDS = {}
for _fam in ("min", "max", "plus", "times"):
    for _t in BUILTIN_TYPES:
        if _t.is_bool:
            continue
        MONOIDS[f"GxB_{_fam.upper()}_{_t.name}_MONOID"] = monoid[_fam][_t]
for _fam in ("lor", "land", "lxor", "eq"):
    MONOIDS[f"GxB_{_fam.upper()}_BOOL_MONOID"] = monoid[_fam][BOOL]
