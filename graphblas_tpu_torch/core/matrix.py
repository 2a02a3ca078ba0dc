"""The bitmap (dense values + pattern) containers: ``Matrix`` and
``Vector``.

Counterpart of ``graphblas_tpu/core/matrix.py``: values in the type's
storage dtype and a bool pattern of the same shape, with absent values
0 (the canonical invariant).  ``Matrix`` is reduced to what the small
dense branch of the sparse ``mxm`` needs; ``Vector`` carries the SpMV
slice (``mxv``/``vxm`` inputs, masks and outputs).  Pending tuples and
element access come with the containers slice, so ``Vector.wait()``
returns the vector itself.

Like the sparse containers, a ``Vector`` lives on the CUDA card unless
the caller passes ``device`` (a constructor without it raises when no
card is present); one built from a tensor keeps the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .errors import DimensionMismatch, IndexOutOfBounds
from .ops import BinaryOp, binary
from .types import Type, cast, type_of_dtype, type_of_storage

__all__ = ["Matrix", "Vector"]


class Matrix:
    """Bitmap matrix: ``values`` (m, n) in ``type.storage`` and
    ``pattern`` (m, n) bool, on one device."""

    __slots__ = ("values", "pattern", "type")

    def __init__(self, values: torch.Tensor, pattern: torch.Tensor,
                 type: Type):
        if values.shape != pattern.shape:
            raise ValueError(f"values {tuple(values.shape)} and pattern "
                             f"{tuple(pattern.shape)} differ in shape")
        self.values = values
        self.pattern = pattern
        self.type = type

    @property
    def shape(self):
        return tuple(self.pattern.shape)

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pattern.device

    def nvals(self) -> int:
        return int(self.pattern.sum())

    def extractTuples(self):
        """(I, J, X) of the entries in row-major order as host arrays, X
        in the type's numpy dtype."""
        I, J = torch.nonzero(self.pattern, as_tuple=True)
        X = self.values[I, J].cpu().numpy()
        if self.type.is_unsigned:
            X = X.view(self.type.dtype)
        return (I.cpu().numpy().astype(np.int64),
                J.cpu().numpy().astype(np.int64), X)

    def __repr__(self):  # pragma: no cover
        return (f"Matrix<{self.type.name}> {self.nrows}x{self.ncols} on "
                f"{self.device}")


# sorted-run duplicate assembly (the JAX package's ``_REDUCEAT_OPS``):
# the named built-in dup operators fold whole runs with one numpy
# reduceat; any other op folds the runs position by position
_REDUCEAT_OPS = {
    "PLUS": np.add, "TIMES": np.multiply, "MIN": np.minimum,
    "MAX": np.maximum, "LOR": np.logical_or, "LAND": np.logical_and,
    "LXOR": np.logical_xor,
}


def _fold_duplicates(dup: BinaryOp, Xs: np.ndarray, starts: np.ndarray,
                     t: Type) -> np.ndarray:
    """Fold each sorted run Xs[starts[k]:starts[k+1]] with the dup op,
    left to right (host values of ``t``'s numpy dtype)."""
    if len(starts) == len(Xs):
        return Xs
    name = dup.name
    if name == "FIRST":
        return Xs[starts]
    if name == "SECOND":
        return Xs[np.append(starts[1:], len(Xs)) - 1]
    ufunc = _REDUCEAT_OPS.get(name)
    if ufunc is not None:
        return ufunc.reduceat(Xs, starts).astype(t.dtype, copy=False)
    ends = np.append(starts[1:], len(Xs))
    out = Xs[starts].copy()
    for k in range(1, int((ends - starts).max())):
        sel = starts + k < ends
        a = torch.from_numpy(t.to_storage(out[sel]))
        b = torch.from_numpy(t.to_storage(Xs[starts[sel] + k]))
        res = dup(a, b).numpy()
        out[sel] = res.view(t.dtype) if t.is_unsigned else res
    return out


def _resolve(device) -> torch.device:
    from ..sparse.container import resolve_device
    return resolve_device(device)


class Vector:
    """A GrB_Vector in bitmap form: ``values`` (n,) in ``type.storage``
    and ``pattern`` (n,) bool, on one device.  (Reference: a vlen x 1
    CSC matrix.)"""

    __slots__ = ("values", "pattern", "type")

    def __init__(self, values: torch.Tensor, pattern: torch.Tensor,
                 type: Type):
        if values.dim() != 1 or values.shape != pattern.shape:
            raise ValueError(f"a Vector needs 1-D values and pattern of "
                             f"one shape, got {tuple(values.shape)} and "
                             f"{tuple(pattern.shape)}")
        self.values = values
        self.pattern = pattern
        self.type = type

    # -- constructors -------------------------------------------------------
    @staticmethod
    def new(type: Type, n: int, device=None) -> "Vector":
        dev = _resolve(device)
        return Vector(torch.zeros(n, dtype=type.storage, device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev), type)

    @staticmethod
    def from_dense(arr, type: Optional[Type] = None, pattern=None,
                   device=None) -> "Vector":
        """Every entry of ``arr`` (numpy or torch, cast to ``type``)
        present, or those ``pattern`` marks."""
        if isinstance(arr, torch.Tensor):
            src = type_of_storage(arr.dtype)
            dev = arr.device if device is None else torch.device(device)
            x = arr.to(dev)
        else:
            a = np.asarray(arr)
            src = type_of_dtype(a.dtype)
            dev = _resolve(device)
            x = torch.from_numpy(np.array(src.to_storage(a))).to(dev)
        t = type or src
        x = cast(x, t, src)
        if pattern is None:
            pat = torch.ones(x.shape, dtype=torch.bool, device=dev)
        else:
            pat = torch.as_tensor(pattern).to(dev, torch.bool)
        if tuple(pat.shape) != tuple(x.shape):
            raise DimensionMismatch(f"pattern shape {tuple(pat.shape)} != "
                                    f"values shape {tuple(x.shape)}")
        return Vector(x, pat, t).canonical()

    @staticmethod
    def from_coo(I, X, n: int, type: Optional[Type] = None,
                 dup: Optional[BinaryOp] = None, device=None) -> "Vector":
        """Build from (index, value) tuples; duplicates fold in input
        order with ``dup`` (default PLUS), as the reference's
        ``GrB_Vector_build``."""
        I = np.asarray(I, dtype=np.int64)
        X = np.asarray(X)
        t = type or type_of_dtype(X.dtype)
        if I.size and (I.min() < 0 or I.max() >= n):
            raise IndexOutOfBounds(f"tuple index out of range for a vector "
                                   f"of size {n}")
        dup = dup or binary.plus[t]
        vals = np.zeros(n, dtype=t.dtype)
        pat = np.zeros(n, dtype=bool)
        if I.size:
            order = np.argsort(I, kind="stable")
            Is, Xs = I[order], X[order]
            if Xs.dtype != t.dtype:
                src = type_of_dtype(Xs.dtype)
                c = cast(torch.from_numpy(np.array(src.to_storage(Xs))), t,
                         src).numpy()
                Xs = c.view(t.dtype) if t.is_unsigned else c
            first = np.ones(len(Is), dtype=bool)
            first[1:] = Is[1:] != Is[:-1]
            starts = np.nonzero(first)[0]
            vals[Is[starts]] = _fold_duplicates(dup, Xs, starts, t)
            pat[Is[starts]] = True
        dev = _resolve(device)
        return Vector(torch.from_numpy(t.to_storage(vals)).to(dev),
                      torch.from_numpy(pat).to(dev), t)

    # -- shape / introspection ----------------------------------------------
    @property
    def shape(self):
        return tuple(self.pattern.shape)

    @property
    def size(self) -> int:
        return self.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pattern.device

    def nvals(self) -> int:
        return int(self.pattern.sum())

    def all_present(self) -> bool:
        """Whether every entry is present (read from the pattern)."""
        return bool(self.pattern.all())

    def wait(self) -> "Vector":
        """No pending tuples yet: the vector itself."""
        return self

    def canonical(self) -> "Vector":
        """Zero the values at absent positions (the storage invariant)."""
        zero = torch.zeros((), dtype=self.values.dtype, device=self.device)
        return Vector(torch.where(self.pattern, self.values, zero),
                      self.pattern, self.type)

    def dup(self) -> "Vector":
        return Vector(self.values, self.pattern, self.type)

    def clear(self) -> "Vector":
        return Vector(torch.zeros_like(self.values),
                      torch.zeros_like(self.pattern), self.type)

    # -- conversion ---------------------------------------------------------
    def _host(self, x: torch.Tensor) -> np.ndarray:
        a = x.cpu().numpy()
        return a.view(self.type.dtype) if self.type.is_unsigned else a

    def extractTuples(self):
        """(I, X) of the entries in index order as host arrays, X in the
        type's numpy dtype."""
        (I,) = torch.nonzero(self.pattern, as_tuple=True)
        return (I.cpu().numpy().astype(np.int64),
                self._host(self.values[I]))

    def to_dense(self, fill=None) -> np.ndarray:
        """Host values; absent entries hold 0, or ``fill``."""
        out = self._host(self.values)
        if fill is not None:
            out = np.where(self.pattern_np(), out,
                           np.asarray(fill, self.type.dtype))
        return out

    def pattern_np(self) -> np.ndarray:
        return self.pattern.cpu().numpy()

    def __repr__(self):  # pragma: no cover
        return f"Vector<{self.type.name}> n={self.size} on {self.device}"
