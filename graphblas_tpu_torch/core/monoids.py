"""Monoids: an associative binary op + identity (+ optional terminal).

Counterpart of ``graphblas_tpu/core/monoids.py``.  Reference:
``Source/GB_Monoid_new.c``, ``GxB_Monoid_terminal_new.c`` and the 44
predefined monoids in ``Include/GraphBLAS.h:5100-5162``.

An identity or terminal is a host scalar of the GraphBLAS type (a numpy
scalar, so UINT identities keep their unsigned value, equal to the JAX
package's); :meth:`Monoid.identity_array` puts it in storage form on a
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .ops import BinaryOp, binary
from .types import BOOL, BUILTIN_TYPES, Type, from_ordered, ordered

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
        """The identity as a Python number of the storage dtype."""
        return self.type.storage_scalar(self.identity)

    def identity_array(self, shape=(), device="cpu") -> torch.Tensor:
        return torch.full(shape, self.identity_value(),
                          dtype=self.type.storage, device=device)

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
        if where is not None:
            x = torch.where(where, x, self.identity_array((), x.device))
        if axis is None:
            x = x.reshape(-1)
            axis = 0
        if nm == "PLUS" and not t.is_bool:
            return torch.sum(x, dim=axis, dtype=x.dtype)
        if nm == "TIMES" and not t.is_bool:
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
        return _pairwise_reduce(self.op, x, axis, self.identity_value())

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


def _pairwise_reduce(op: BinaryOp, x: torch.Tensor, axis: int, identity):
    """Log-depth associative fold along ``axis``."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    while n > 1:
        half = n // 2
        merged = op(x[:half], x[half:2 * half])
        if n % 2:
            merged = torch.cat([merged, x[2 * half:2 * half + 1]], dim=0)
        x = merged
        n = x.shape[0]
    if n == 0:
        return torch.full(x.shape[1:], identity, dtype=x.dtype,
                          device=x.device)
    return x[0]


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
