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

Over a user-defined type ``values`` is a dict of tensors, one per field
(nested dicts for nested structs), each of the container's shape in its
field type's storage (:mod:`graphblas_tpu_torch.core.types`).  Such a
container is made by ``new`` or by ``from_dense`` of a dict of arrays;
``from_coo`` raises ``TypeError`` for it, as the JAX package's does,
and its pending tuples fold one by one (the JAX package's per-tuple
path).  The element and tuple accessors and ``to_dense`` return dicts
of host arrays or numpy scalars.

Like the sparse containers, a container lives on the CUDA card unless
the caller passes ``device`` (a constructor without it raises when no
card is present); one built from a tensor keeps the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import faultinject
from ..utils.tree import tree_map
from .errors import DimensionMismatch, IndexOutOfBounds
from .ops import BinaryOp, binary
from .types import (Type, cast, cast_result, cast_value, full_typed,
                    tree_where, type_of_dtype, type_of_storage,
                    value_shape, zeros_like_typed)

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


def _typed(t) -> Optional[Type]:
    """``t`` itself when it is None or a Type; raise otherwise."""
    if t is not None and not isinstance(t, Type):
        raise TypeError(f"expected a GraphBLAS Type, got {t!r}")
    return t


def host_values(x, t: Type):
    """Device values of type ``t`` as host arrays of the type's own
    dtype (unsigned read as unsigned; a dict per field for a struct)."""
    if t.is_udt:
        return {k: host_values(x[k], ft) for k, ft in t.fields}
    a = x.cpu().numpy()
    return a.view(t.dtype) if t.is_unsigned else a


def device_values(X, t: Type, device):
    """Host values of type ``t`` (a dict per field for a struct) as
    tensors in ``t``'s storage on ``device``: the inverse of
    :func:`host_values`."""
    if t.is_udt:
        return {k: device_values(X[k], ft, device) for k, ft in t.fields}
    a = np.asarray(X).astype(t.dtype, copy=False)
    return torch.from_numpy(np.array(t.to_storage(a))).to(device)


def _leaf_to(arr, t: Optional[Type], device):
    """(tensor in ``t``'s storage on the device, device) of one array."""
    if isinstance(arr, torch.Tensor):
        src = type_of_storage(arr.dtype)
        dev = arr.device if device is None else torch.device(device)
        x = arr.to(dev)
    else:
        a = np.asarray(arr)
        src = type_of_dtype(a.dtype)
        dev = _resolve(device)
        x = torch.from_numpy(np.array(src.to_storage(a))).to(dev)
    t = t or src
    return cast(x, t, src), dev, t


def _udt_leaves(arr, t: Type, device):
    """A dict of per-field arrays as tensors in the fields' storage."""
    if not isinstance(arr, dict):
        raise TypeError(f"values of the user-defined type {t.name} must be "
                        f"a dict of field arrays")
    out, dev = {}, None
    for k, ft in t.fields:
        if ft.is_udt:
            out[k], dev = _udt_leaves(arr[k], ft, device)
        else:
            out[k], dev, _ = _leaf_to(arr[k], ft, device)
    return out, dev


def _dense_parts(arr, type: Optional[Type], pattern, device):
    """(values in ``type``'s storage, bool pattern, type) of a numpy
    array or tensor (a dict of field arrays for a user-defined type),
    every entry present unless ``pattern`` says."""
    _typed(type)
    if type is not None and type.is_udt:
        x, dev = _udt_leaves(arr, type, device)
        t = type
        shape = value_shape(x)
    else:
        if isinstance(arr, dict):
            raise TypeError("struct values need their user-defined type")
        x, dev, t = _leaf_to(arr, type, device)
        shape = tuple(x.shape)
    if pattern is None:
        pat = torch.ones(shape, dtype=torch.bool, device=dev)
    else:
        pat = torch.as_tensor(pattern).to(dev, torch.bool)
    if tuple(pat.shape) != tuple(shape):
        raise DimensionMismatch(f"pattern shape {tuple(pat.shape)} != "
                                f"values shape {tuple(shape)}")
    return x, pat, t



def _assemble(key: np.ndarray, X, size: int, type: Optional[Type],
              dup: Optional[BinaryOp]):
    """Host (values, pattern, type) of ``size`` flat slots from tuples
    at the linear positions ``key``: duplicates fold in input order with
    ``dup`` (default PLUS), as the reference's ``GB_builder``."""
    if type is not None and _typed(type).is_udt:
        raise TypeError(
            "from_coo does not assemble struct (user-defined) tuples; "
            "build with new(type, ...) + setElement + wait, or from_dense "
            "with a dict of field arrays")
    X = np.asarray(X)
    t = type or type_of_dtype(X.dtype)
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

    __slots__ = ("values", "pattern", "type", "_pending", "_options")

    def _init(self, values, pattern, type, pending, options=None):
        self.values = values
        self.pattern = pattern
        self.type = _typed(type)
        # the non-blocking delta list: (index tuple, scalar, accum op)
        self._pending = as_pending(pending)
        # per-object options (GxB_Matrix_Option_set scope): set through
        # the facade, carried by every container derived through
        # _replace (setElement, wait, canonical, dup)
        self._options = dict(options) if options else {}

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
        # the universal new-container site (every derived container
        # lands here): the faultable "allocation" of the functional
        # design, as in the JAX package
        faultinject.checkpoint("Matrix._replace")
        return type(self)(self.values if values is None else values,
                          self.pattern if pattern is None else pattern,
                          self.type,
                          self._pending if pending is None else pending,
                          self._options)

    def wait(self):
        """Fold the pending tuples (reference ``GB_wait``): per run of
        one accum op, duplicates fold on the host in input order and the
        run lands in one scatter to distinct positions; a position
        already present takes accum(old, new), or new without accum."""
        if not self._pending:
            return self
        faultinject.checkpoint("Matrix.wait")
        t = self.type
        shape = self.shape
        dev = self.device
        if t.is_udt:
            return self._wait_udt()
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

    def _wait_udt(self):
        """The per-tuple fold of a user-defined type's pending tuples
        (the JAX package's UDT path): each tuple lands in turn, taking
        accum(old, new) where the entry is present."""
        t = self.type
        vals = tree_map(lambda v: v.clone(), self.values)
        pat = self.pattern.clone()
        dev = self.device
        for idx, scalar, accum in self._pending:
            s = full_typed((), cast_value(scalar, t), t, dev)
            if accum is not None:
                old = tree_map(lambda v: v[idx], vals)
                s = tree_where(pat[idx], cast_result(accum(old, s), t), s)

            def put(v, x):
                v[idx] = x.to(v.dtype)
            tree_map(put, vals, s)
            pat[idx] = True
        return self._replace(vals, pat, Pending()).canonical()

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
        zero = zeros_like_typed((), self.type, self.device)
        return self._replace(values=tree_where(self.pattern, self.values,
                                               zero))

    def dup(self):
        return self._replace()

    def clear(self):
        """Every entry removed; shape and type kept (``GrB_*_clear``)."""
        return type(self)(zeros_like_typed(self.shape, self.type,
                                           self.device),
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
        return tree_map(lambda a: a[0], m._host(
            tree_map(lambda v: v[idx].reshape(1), m.values)))

    def removeElement(self, *index):
        idx = self._index(index)
        m = self.wait()
        pat = m.pattern.clone()
        pat[idx] = False
        return m._replace(pattern=pat).canonical()

    # -- conversion ---------------------------------------------------------
    def _host(self, x):
        return host_values(x, self.type)

    def to_dense(self, fill=None):
        """Host values; absent entries hold 0, or ``fill`` (in every
        field of a struct, each in its field's dtype)."""
        m = self.wait()
        out = m._host(m.values)
        if fill is not None:
            pat = m.pattern_np()
            out = tree_map(lambda a: np.where(pat, a, np.asarray(
                fill).astype(a.dtype)), out)
        return out

    def pattern_np(self) -> np.ndarray:
        return self.wait().pattern.cpu().numpy()


class Matrix(_Bitmap):
    """A GrB_Matrix in bitmap form: ``values`` (m, n) in ``type.storage``
    and ``pattern`` (m, n) bool, on one device."""

    __slots__ = ()

    def __init__(self, values, pattern: torch.Tensor,
                 type: Type, pending=None, options=None):
        shape = value_shape(values)
        if len(shape) != 2 or shape != tuple(pattern.shape):
            raise ValueError(f"a Matrix needs 2-D values and pattern of "
                             f"one shape, got {shape} and "
                             f"{tuple(pattern.shape)}")
        self._init(values, pattern, type, pending, options)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def new(type: Type, nrows: int, ncols: int, device=None) -> "Matrix":
        faultinject.checkpoint("Matrix.new")
        _typed(type)
        dev = _resolve(device)
        return Matrix(zeros_like_typed((nrows, ncols), type, dev),
                      torch.zeros((nrows, ncols), dtype=torch.bool,
                                  device=dev), type)

    @staticmethod
    def from_dense(arr, type: Optional[Type] = None, pattern=None,
                   device=None) -> "Matrix":
        """Every entry of the 2-D ``arr`` (numpy or torch, cast to
        ``type``) present, or those ``pattern`` marks."""
        faultinject.checkpoint("Matrix.from_dense")
        return Matrix(*_dense_parts(arr, type, pattern, device)).canonical()

    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None,
                 dup: Optional[BinaryOp] = None, device=None) -> "Matrix":
        """Build from (i, j, value) tuples; duplicates fold in input
        order with ``dup`` (default PLUS), as the reference's
        ``GrB_Matrix_build``."""
        faultinject.checkpoint("Matrix.from_coo")
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
        vals = zeros_like_typed((nrows, ncols), m.type, m.device)
        pat = torch.zeros((nrows, ncols), dtype=torch.bool,
                          device=m.device)
        r, c = min(nrows, m.nrows), min(ncols, m.ncols)

        def put(v, x):
            v[:r, :c] = x[:r, :c]
        tree_map(put, vals, m.values)
        pat[:r, :c] = m.pattern[:r, :c]
        return Matrix(vals, pat, m.type)

    def T(self) -> "Matrix":
        """Structural transpose (no mask or accum)."""
        m = self.wait()
        return Matrix(tree_map(lambda v: v.T.contiguous(), m.values),
                      m.pattern.T.contiguous(), m.type)

    # -- tuples and iteration -------------------------------------------------
    def extractTuples(self):
        """(I, J, X) of the entries in row-major order as host arrays, X
        in the type's numpy dtype."""
        m = self.wait()
        I, J = torch.nonzero(m.pattern, as_tuple=True)
        return (I.cpu().numpy().astype(np.int64),
                J.cpu().numpy().astype(np.int64),
                m._host(tree_map(lambda v: v[I, J], m.values)))

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

    def __init__(self, values, pattern: torch.Tensor,
                 type: Type, pending=None, options=None):
        shape = value_shape(values)
        if len(shape) != 1 or shape != tuple(pattern.shape):
            raise ValueError(f"a Vector needs 1-D values and pattern of "
                             f"one shape, got {shape} and "
                             f"{tuple(pattern.shape)}")
        self._init(values, pattern, type, pending, options)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def new(type: Type, n: int, device=None) -> "Vector":
        _typed(type)
        dev = _resolve(device)
        return Vector(zeros_like_typed(n, type, dev),
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
                v._host(tree_map(lambda x: x[I], v.values)))

    def resize(self, n: int) -> "Vector":
        """``GxB_Vector_resize``: grow with empties, shrink pruning."""
        v = self.wait()
        vals = zeros_like_typed(n, v.type, v.device)
        pat = torch.zeros(n, dtype=torch.bool, device=v.device)
        k = min(n, v.size)

        def put(a, x):
            a[:k] = x[:k]
        tree_map(put, vals, v.values)
        pat[:k] = v.pattern[:k]
        return Vector(vals, pat, v.type)

    def __repr__(self):  # pragma: no cover
        return f"Vector<{self.type.name}> n={self.size} on {self.device}"
