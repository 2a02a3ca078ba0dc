"""The bitmap (dense values + pattern) containers: ``Matrix`` and
``Vector``.

Counterpart of ``graphblas_tpu/core/matrix.py``: values in the type's
storage dtype and a bool pattern of the same shape, with absent values
0 (the canonical invariant).  ``Matrix`` is the output and operand of
the bitmap ``mxm`` (the dense engines, the tropical kernel and the SpMM
fast path); ``Vector`` carries SpMV (``mxv``/``vxm`` inputs, masks and
outputs).  Both are functional: every method returns a new container.
``setElement`` appends a pending tuple to a host-side list (the
reference's ``GB_pending_add``, non-blocking mode) and ``wait`` folds
the list: duplicates fold on the host in input order, each run of one
accum op lands in one scatter to distinct positions (scattering to a
repeated index is undefined on CUDA), as the JAX package's
``Matrix.wait``.  Every read of a container (``nvals``, the element and
tuple accessors, ``to_dense``, the operations) folds first.
User-defined types come with a later slice: a type that is not a
builtin ``Type`` raises.

Like the sparse containers, a container lives on the CUDA card unless
the caller passes ``device`` (a constructor without it raises when no
card is present); one built from a tensor keeps the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .errors import DimensionMismatch, IndexOutOfBounds
from .ops import BinaryOp, binary
from .types import (Type, cast, cast_result, cast_value, type_of_dtype,
                    type_of_storage)

__all__ = ["Matrix", "Vector"]


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


def _fold_runs(xs: np.ndarray, starts: np.ndarray,
               accum: Optional[BinaryOp], t: Type) -> np.ndarray:
    """The value each sorted run of one key folds to: the last write
    when ``accum`` is None (``GB_setElement`` overwrites), else the run
    folded left to right with ``accum``."""
    if accum is None:
        return xs[np.append(starts[1:], len(xs)) - 1]
    return _fold_duplicates(accum, xs, starts, t)


def accum_apply(accum: BinaryOp, c: torch.Tensor, x: torch.Tensor,
                t: Type) -> torch.Tensor:
    """accum(c, x) for values c, x of type ``t``, the result in ``t``."""
    z = accum(cast(c, accum.xtype, t), cast(x, accum.ytype, t))
    return cast(cast_result(z, accum.ztype), t, accum.ztype)


class Pending:
    """A container's pending tuples: a read-only sequence over a host
    list that the containers derived from one another share.  Adding a
    tuple to the newest of them extends the shared list in place, O(1);
    adding one to an older container copies its own prefix first, so
    every container keeps exactly its tuples (``setElement`` stays
    functional without copying the list on every call)."""

    __slots__ = ("_buf", "_n")

    def __init__(self, items=()):
        self._buf = list(items)
        self._n = len(self._buf)

    def plus(self, item) -> "Pending":
        """This list with ``item`` appended, as a new Pending."""
        if self._n == len(self._buf):
            buf = self._buf
            buf.append(item)
        else:
            buf = self._buf[:self._n] + [item]
        out = Pending.__new__(Pending)
        out._buf, out._n = buf, len(buf)
        return out

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self._buf[:self._n])

    def __getitem__(self, k):
        return self._buf[:self._n][k]

    def __eq__(self, other) -> bool:
        return list(self) == list(other)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Pending({list(self)!r})"


def as_pending(pending) -> Pending:
    """``pending`` (None, a list of tuples or a Pending) as a Pending."""
    if isinstance(pending, Pending):
        return pending
    return Pending(pending or ())


def pending_runs(pending) -> list:
    """Consecutive pending tuples that share an accum op, as
    [(accum, [tuple without its accum, ...]), ...]: a later overwrite
    must not fold across an intervening accum run."""
    runs: list = []
    for *rest, accum in pending:
        if runs and runs[-1][0] is accum:
            runs[-1][1].append(tuple(rest))
        else:
            runs.append((accum, [tuple(rest)]))
    return runs


def global_blocking() -> bool:
    """Whether the global mode folds each ``setElement`` at once
    (``GrB_BLOCKING``)."""
    from .options import BLOCKING, global_options
    return global_options().mode == BLOCKING


def _resolve(device) -> torch.device:
    from ..sparse.container import resolve_device
    return resolve_device(device)


def _builtin(t) -> Optional[Type]:
    """``t`` itself when it is None or a builtin Type; raise otherwise."""
    if t is not None and not isinstance(t, Type):
        raise NotImplementedError(
            f"user-defined types come with a later slice of the port "
            f"(got {t!r}); use a builtin Type")
    return t


def _dense_parts(arr, type: Optional[Type], pattern, device):
    """(values in ``type``'s storage, bool pattern, type) of a numpy
    array or tensor, every entry present unless ``pattern`` says."""
    _builtin(type)
    if isinstance(arr, dict):
        raise NotImplementedError("user-defined (struct) values come with "
                                  "a later slice of the port")
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
    return x, pat, t


def _assemble(key: np.ndarray, X, size: int, type: Optional[Type],
              dup: Optional[BinaryOp]):
    """Host (values, pattern, type) of ``size`` flat slots from tuples
    at the linear positions ``key``: duplicates fold in input order with
    ``dup`` (default PLUS), as the reference's ``GB_builder``."""
    X = np.asarray(X)
    t = _builtin(type) or type_of_dtype(X.dtype)
    dup = dup or binary.plus[t]
    vals = np.zeros(size, dtype=t.dtype)
    pat = np.zeros(size, dtype=bool)
    if key.size:
        order = np.argsort(key, kind="stable")
        ks, Xs = key[order], X[order]
        if Xs.dtype != t.dtype:
            src = type_of_dtype(Xs.dtype)
            c = cast(torch.from_numpy(np.array(src.to_storage(Xs))), t,
                     src).numpy()
            Xs = c.view(t.dtype) if t.is_unsigned else c
        first = np.ones(len(ks), dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        starts = np.nonzero(first)[0]
        vals[ks[starts]] = _fold_duplicates(dup, Xs, starts, t)
        pat[ks[starts]] = True
    return vals, pat, t


class _Bitmap:
    """What ``Matrix`` and ``Vector`` share: ``values`` in
    ``type.storage`` and a bool ``pattern`` of one shape, on one
    device."""

    __slots__ = ("values", "pattern", "type", "_pending")

    def _init(self, values, pattern, type, pending):
        self.values = values
        self.pattern = pattern
        self.type = _builtin(type)
        # the non-blocking delta list: (index tuple, scalar, accum op)
        self._pending = as_pending(pending)

    @property
    def shape(self):
        return tuple(self.pattern.shape)

    @property
    def device(self) -> torch.device:
        return self.pattern.device

    def nvals(self) -> int:
        """The number of entries (``GrB_*_nvals``; folds first)."""
        return int(self.wait().pattern.sum())

    def _replace(self, values=None, pattern=None, pending=None):
        return type(self)(self.values if values is None else values,
                          self.pattern if pattern is None else pattern,
                          self.type,
                          self._pending if pending is None else pending)

    def wait(self):
        """Fold the pending tuples (reference ``GB_wait``): per run of
        one accum op, duplicates fold on the host in input order and the
        run lands in one scatter to distinct positions; a position
        already present takes accum(old, new), or new without accum."""
        if not self._pending:
            return self
        t = self.type
        shape = self.shape
        dev = self.device
        vals = self.values.flatten().clone()
        pat = self.pattern.flatten().clone()
        for accum, tuples in pending_runs(self._pending):
            idx = np.asarray([i for i, _ in tuples], np.int64)
            key = np.ravel_multi_index(idx.T, shape).astype(np.int64)
            xs = np.asarray([cast_value(x, t) for _, x in tuples],
                            dtype=t.dtype)
            order = np.argsort(key, kind="stable")
            key, xs = key[order], xs[order]
            first = np.ones(len(key), bool)
            first[1:] = key[1:] != key[:-1]
            starts = np.nonzero(first)[0]
            tgt = torch.from_numpy(key[starts]).to(dev)
            new = torch.from_numpy(
                t.to_storage(_fold_runs(xs, starts, accum, t))).to(dev)
            if accum is not None:
                new = torch.where(pat[tgt], accum_apply(accum, vals[tgt],
                                                        new, t), new)
            vals[tgt] = new
            pat[tgt] = True
        return self._replace(vals.reshape(shape), pat.reshape(shape),
                             Pending()).canonical()

    def setElement(self, value, *index, accum: Optional[BinaryOp] = None,
                   blocking: Optional[bool] = None):
        """Functional setElement: the tuple joins the pending list
        (reference ``GB_setElement`` -> ``GB_pending_add``) and folds at
        the next :meth:`wait`; ``blocking`` (default: the global mode)
        folds it at once."""
        idx = self._index(index)
        if accum is not None and not isinstance(accum, BinaryOp):
            raise TypeError(f"setElement accum must be a BinaryOp, got "
                            f"{accum!r}")
        if blocking is None:
            blocking = global_blocking()
        out = self._replace(pending=self._pending.plus((idx, value, accum)))
        return out.wait() if blocking else out

    def canonical(self):
        """Zero the values at absent positions (the storage invariant)."""
        zero = torch.zeros((), dtype=self.values.dtype, device=self.device)
        return self._replace(values=torch.where(self.pattern, self.values,
                                                zero))

    def dup(self):
        return self._replace()

    def clear(self):
        """Every entry removed; shape and type kept (``GrB_*_clear``)."""
        return type(self)(torch.zeros_like(self.values),
                          torch.zeros_like(self.pattern), self.type)

    def _index(self, index) -> tuple:
        """``index`` as a tuple of ints, checked against the shape
        (``GrB_INVALID_INDEX``)."""
        idx = tuple(int(i) for i in index)
        if len(idx) != len(self.shape) or not all(
                0 <= i < d for i, d in zip(idx, self.shape)):
            raise IndexOutOfBounds(f"index {idx} out of range for shape "
                                   f"{self.shape}")
        return idx

    def extractElement(self, *index):
        """The entry's value as a numpy scalar of the type, or None when
        it is absent (``GrB_NO_VALUE``)."""
        idx = self._index(index)
        m = self.wait()
        if not bool(m.pattern[idx]):
            return None
        return m._host(m.values[idx].reshape(1))[0]

    def removeElement(self, *index):
        idx = self._index(index)
        m = self.wait()
        pat = m.pattern.clone()
        pat[idx] = False
        return m._replace(pattern=pat).canonical()

    # -- conversion ---------------------------------------------------------
    def _host(self, x: torch.Tensor) -> np.ndarray:
        a = x.cpu().numpy()
        return a.view(self.type.dtype) if self.type.is_unsigned else a

    def to_dense(self, fill=None) -> np.ndarray:
        """Host values; absent entries hold 0, or ``fill``."""
        m = self.wait()
        out = m._host(m.values)
        if fill is not None:
            out = np.where(m.pattern_np(), out,
                           np.asarray(fill, m.type.dtype))
        return out

    def pattern_np(self) -> np.ndarray:
        return self.wait().pattern.cpu().numpy()


class Matrix(_Bitmap):
    """A GrB_Matrix in bitmap form: ``values`` (m, n) in ``type.storage``
    and ``pattern`` (m, n) bool, on one device."""

    __slots__ = ()

    def __init__(self, values: torch.Tensor, pattern: torch.Tensor,
                 type: Type, pending=None):
        if values.dim() != 2 or values.shape != pattern.shape:
            raise ValueError(f"a Matrix needs 2-D values and pattern of "
                             f"one shape, got {tuple(values.shape)} and "
                             f"{tuple(pattern.shape)}")
        self._init(values, pattern, type, pending)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def new(type: Type, nrows: int, ncols: int, device=None) -> "Matrix":
        _builtin(type)
        dev = _resolve(device)
        return Matrix(torch.zeros((nrows, ncols), dtype=type.storage,
                                  device=dev),
                      torch.zeros((nrows, ncols), dtype=torch.bool,
                                  device=dev), type)

    @staticmethod
    def from_dense(arr, type: Optional[Type] = None, pattern=None,
                   device=None) -> "Matrix":
        """Every entry of the 2-D ``arr`` (numpy or torch, cast to
        ``type``) present, or those ``pattern`` marks."""
        return Matrix(*_dense_parts(arr, type, pattern, device)).canonical()

    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None,
                 dup: Optional[BinaryOp] = None, device=None) -> "Matrix":
        """Build from (i, j, value) tuples; duplicates fold in input
        order with ``dup`` (default PLUS), as the reference's
        ``GrB_Matrix_build``."""
        I = np.asarray(I, dtype=np.int64)
        J = np.asarray(J, dtype=np.int64)
        if I.size and (I.min() < 0 or I.max() >= nrows or J.min() < 0
                       or J.max() >= ncols):
            raise IndexOutOfBounds(f"tuple index out of range for "
                                   f"{nrows}x{ncols} matrix")
        vals, pat, t = _assemble(I * ncols + J, X, nrows * ncols, type, dup)
        dev = _resolve(device)
        return Matrix(
            torch.from_numpy(t.to_storage(vals).reshape(nrows, ncols)).to(dev),
            torch.from_numpy(pat.reshape(nrows, ncols)).to(dev), t)

    @staticmethod
    def from_scipy(sp, type: Optional[Type] = None,
                   device=None) -> "Matrix":
        coo = sp.tocoo()
        return Matrix.from_coo(coo.row, coo.col, coo.data, *sp.shape,
                               type=type, device=device)

    # -- shape ----------------------------------------------------------------
    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def resize(self, nrows: int, ncols: int) -> "Matrix":
        """``GxB_Matrix_resize``: grow with empties, shrink pruning."""
        m = self.wait()
        vals = torch.zeros((nrows, ncols), dtype=m.values.dtype,
                           device=m.device)
        pat = torch.zeros((nrows, ncols), dtype=torch.bool,
                          device=m.device)
        r, c = min(nrows, m.nrows), min(ncols, m.ncols)
        vals[:r, :c] = m.values[:r, :c]
        pat[:r, :c] = m.pattern[:r, :c]
        return Matrix(vals, pat, m.type)

    def T(self) -> "Matrix":
        """Structural transpose (no mask or accum)."""
        m = self.wait()
        return Matrix(m.values.T.contiguous(), m.pattern.T.contiguous(),
                      m.type)

    # -- tuples and iteration -------------------------------------------------
    def extractTuples(self):
        """(I, J, X) of the entries in row-major order as host arrays, X
        in the type's numpy dtype."""
        m = self.wait()
        I, J = torch.nonzero(m.pattern, as_tuple=True)
        return (I.cpu().numpy().astype(np.int64),
                J.cpu().numpy().astype(np.int64),
                m._host(m.values[I, J]))

    def rows(self):
        """Iterate (i, cols, vals) over the nonempty rows (the
        ``GBI_for_each_vector`` iterator)."""
        pat = self.pattern_np()
        vals = self.to_dense()
        for i in np.nonzero(pat.any(axis=1))[0]:
            cols = np.nonzero(pat[i])[0]
            yield int(i), cols, vals[i][cols]

    def cols(self):
        """Iterate (j, rows, vals) over the nonempty columns."""
        return self.T().rows()

    def __repr__(self):  # pragma: no cover
        return (f"Matrix<{self.type.name}> {self.nrows}x{self.ncols} on "
                f"{self.device}" + (f", {len(self._pending)} pending"
                                    if self._pending else ""))


class Vector(_Bitmap):
    """A GrB_Vector in bitmap form: ``values`` (n,) in ``type.storage``
    and ``pattern`` (n,) bool, on one device.  (Reference: a vlen x 1
    CSC matrix.)"""

    __slots__ = ()

    def __init__(self, values: torch.Tensor, pattern: torch.Tensor,
                 type: Type, pending=None):
        if values.dim() != 1 or values.shape != pattern.shape:
            raise ValueError(f"a Vector needs 1-D values and pattern of "
                             f"one shape, got {tuple(values.shape)} and "
                             f"{tuple(pattern.shape)}")
        self._init(values, pattern, type, pending)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def new(type: Type, n: int, device=None) -> "Vector":
        _builtin(type)
        dev = _resolve(device)
        return Vector(torch.zeros(n, dtype=type.storage, device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev), type)

    @staticmethod
    def from_dense(arr, type: Optional[Type] = None, pattern=None,
                   device=None) -> "Vector":
        """Every entry of ``arr`` (numpy or torch, cast to ``type``)
        present, or those ``pattern`` marks."""
        return Vector(*_dense_parts(arr, type, pattern, device)).canonical()

    @staticmethod
    def from_coo(I, X, n: int, type: Optional[Type] = None,
                 dup: Optional[BinaryOp] = None, device=None) -> "Vector":
        """Build from (index, value) tuples; duplicates fold in input
        order with ``dup`` (default PLUS), as the reference's
        ``GrB_Vector_build``."""
        I = np.asarray(I, dtype=np.int64)
        if I.size and (I.min() < 0 or I.max() >= n):
            raise IndexOutOfBounds(f"tuple index out of range for a vector "
                                   f"of size {n}")
        vals, pat, t = _assemble(I, X, n, type, dup)
        dev = _resolve(device)
        return Vector(torch.from_numpy(t.to_storage(vals)).to(dev),
                      torch.from_numpy(pat).to(dev), t)

    # -- shape / introspection ----------------------------------------------
    @property
    def size(self) -> int:
        return self.shape[0]

    def all_present(self) -> bool:
        """Whether every entry is present (read from the pattern)."""
        return bool(self.wait().pattern.all())

    def extractTuples(self):
        """(I, X) of the entries in index order as host arrays, X in the
        type's numpy dtype."""
        v = self.wait()
        (I,) = torch.nonzero(v.pattern, as_tuple=True)
        return (I.cpu().numpy().astype(np.int64),
                v._host(v.values[I]))

    def resize(self, n: int) -> "Vector":
        """``GxB_Vector_resize``: grow with empties, shrink pruning."""
        v = self.wait()
        vals = torch.zeros(n, dtype=v.values.dtype, device=v.device)
        pat = torch.zeros(n, dtype=torch.bool, device=v.device)
        k = min(n, v.size)
        vals[:k] = v.values[:k]
        pat[:k] = v.pattern[:k]
        return Vector(vals, pat, v.type)

    def __repr__(self):  # pragma: no cover
        return f"Vector<{self.type.name}> n={self.size} on {self.device}"
