"""Build the port's containers and plans from the JAX package's, through
numpy arrays only (this module imports no JAX).

A JAX-side object is read attribute by attribute with ``np.asarray``, so
both packages can compute on exactly the same containers, plans and
semirings — the parity tests' "weights".  Each ``*_from_arrays``
function takes plain arrays and metadata; :func:`from_jax` reads them
off a JAX package ``CsrMatrix`` (pattern-only or valued: FP32, INT32,
FP64, BOOL and the other builtin types), ``CscMatrix``, bitmap
``Matrix``, ``Vector``, ``BandPlan``, ``WindowPlan``, ``TilePattern``,
``Semiring`` (by its operator names and type) or BSR SpMV plan (the
8-tuple ``bsr_spmv_plan`` returns), and the hypersparse ``HyperMatrix``,
``HyperCscMatrix`` and ``SparseVec``.  A container's pending tuples come
across as host tuples (their accum ops as the port's builtin op of the
same name and types), to be folded by the port's ``wait``; a
hypersparse container also carries its options (``hyper_ratio``,
``format``).

Complex containers (FC32, FC64) come across as any builtin type does.
A user-defined type comes across as the port's ``Type.udt`` of the same
name and fields (recursively), and its dict values leaf by leaf, on
every container, pending tuples included.  A JAX user-defined op is not
carried (its body is JAX code): a pending tuple whose accum is one
raises ``TypeError``; build the port's op and re-run.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.matrix import Matrix, Vector, as_pending
from .core.ops import binary
from .core.semirings import Semiring, semiring
from .core.types import Type, type_by_name
from .utils.tree import tree_map
from .sparse.bsr import TilePattern
from .sparse.container import CscMatrix, CsrMatrix, resolve_device
from .sparse.cuda_spmv import BsrSpmvPlan
from .sparse.hyper import HyperMatrix
from .sparse.hyper_csc import HyperCscMatrix
from .sparse.vector import SparseVec
from .sparse.window import BandPlan, WindowPlan

__all__ = ["csr_from_arrays", "hyper_from_arrays", "matrix_from_arrays",
           "type_from_jax",
           "vector_from_arrays",
           "band_plan_from_arrays", "window_plan_from_arrays",
           "bsr_spmv_plan_from_arrays", "tile_pattern_from_arrays",
           "semiring_by_name", "from_jax"]


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def type_from_jax(t) -> Type:
    """The port's Type of a JAX package Type: the builtin or complex
    type of its name, or a user-defined type of the same name and
    fields."""
    if getattr(t, "fields", None) is not None:
        return Type.udt(t.name, **{k: type_from_jax(ft)
                                   for k, ft in t.fields})
    return type_by_name(t.name)


def _type(t) -> Type:
    return t if isinstance(t, Type) else type_by_name(t)


def _values(values, t: Type, device):
    """Host values (a dict per field for a user-defined type) as tensors
    in ``t``'s storage on ``device``."""
    if t.is_udt:
        return {k: _values(values[k], ft, device) for k, ft in t.fields}
    return _dev(t.to_storage(np.asarray(values)), device)


def csr_from_arrays(indptr, indices, rowids, values, nvals: int,
                    nrows: int, ncols: int, type_name: str,
                    host_pattern=None, device=None) -> CsrMatrix:
    """CsrMatrix from the padded arrays of the same layout."""
    device = resolve_device(device)
    t = _type(type_name)
    A = CsrMatrix(_dev(np.asarray(indptr, np.int32), device),
                  _dev(np.asarray(indices, np.int32), device),
                  _dev(np.asarray(rowids, np.int32), device),
                  _values(values, t, device),
                  nvals, nrows, ncols, t)
    if host_pattern is not None:
        A._options["host_pattern"] = (np.asarray(host_pattern[0]),
                                      np.asarray(host_pattern[1]))
    return A


def hyper_from_arrays(h, hptr, rowids, indices, values, nvals: int,
                      nvec: int, nrows: int, ncols: int, type_name: str,
                      device=None) -> HyperMatrix:
    """HyperMatrix from the padded arrays of the same layout."""
    device = resolve_device(device)
    t = _type(type_name)
    return HyperMatrix(_dev(np.asarray(h, np.int64), device),
                       _dev(np.asarray(hptr, np.int32), device),
                       _dev(np.asarray(rowids, np.int64), device),
                       _dev(np.asarray(indices, np.int64), device),
                       _values(values, t, device),
                       nvals, nvec, nrows, ncols, t)


def matrix_from_arrays(values, pattern, type_name: str,
                       device=None) -> Matrix:
    """Bitmap Matrix from its values and pattern."""
    device = resolve_device(device)
    t = _type(type_name)
    return Matrix(_values(values, t, device),
                  _dev(np.asarray(pattern, bool), device), t)


def vector_from_arrays(values, pattern, type_name: str,
                       device=None) -> Vector:
    """Bitmap Vector from its values and pattern."""
    device = resolve_device(device)
    t = _type(type_name)
    return Vector(_values(values, t, device),
                  _dev(np.asarray(pattern, bool), device), t)


def bsr_spmv_plan_from_arrays(rb, cb, slot, valid, tiles, nrb: int,
                              ncb: int, ntiles: int,
                              device=None) -> BsrSpmvPlan:
    """BSR SpMV plan from the JAX package's arrays (``rbptr``, the first
    triple of each row-block, is derived from the sorted ``rb``)."""
    device = resolve_device(device)
    rb = np.asarray(rb, np.int32)
    rbptr = np.searchsorted(rb, np.arange(nrb + 1)).astype(np.int32)
    return BsrSpmvPlan(
        _dev(rb, device), _dev(np.asarray(cb, np.int32), device),
        _dev(np.asarray(slot, np.int32), device),
        _dev(np.asarray(valid, np.int32), device),
        _dev(np.asarray(tiles, np.float32), device), int(nrb), int(ncb),
        int(ntiles), _dev(rbptr, device))


def band_plan_from_arrays(P, Ut, nI: int, Wb: int, ntriples: int,
                          nedges: int, device=None) -> BandPlan:
    device = resolve_device(device)
    return BandPlan(_dev(np.asarray(P, np.int8), device),
                    _dev(np.asarray(Ut, np.int8), device),
                    nI, Wb, ntriples, nedges)


def window_plan_from_arrays(P, Q, M, nI: int, Wmax: int, nJmax: int, k0,
                            j0, ntriples: int, shape, mshape,
                            device=None) -> WindowPlan:
    device = resolve_device(device)
    return WindowPlan(_dev(np.asarray(P, np.int8), device),
                      _dev(np.asarray(Q, np.int8), device),
                      _dev(np.asarray(M, np.int8), device),
                      nI, Wmax, nJmax, np.asarray(k0), np.asarray(j0),
                      ntriples, tuple(shape), tuple(mshape))


def tile_pattern_from_arrays(tiles, grid, index, shape, T: int,
                             device=None) -> TilePattern:
    """TilePattern from its stacked tiles (any dtype, kept) and numpy
    grid and index."""
    return TilePattern(_dev(np.asarray(tiles), resolve_device(device)),
                       np.array(grid, bool), np.array(index, np.int32),
                       tuple(shape), int(T))


def semiring_by_name(add_name: str, mult_name: str,
                     type_name: str) -> Semiring:
    """The builtin semiring of add monoid ``add_name`` over mult op
    ``mult_name`` of type ``type_name`` ("PLUS", "TIMES", "FP32")."""
    return semiring[f"{add_name}_{mult_name}".lower()][
        type_by_name(type_name)]


def _accum_of(op):
    """The port's builtin binary op of a JAX package accum op's name and
    types (or None)."""
    if op is None:
        return None
    if any(getattr(t, "fields", None) is not None
           for t in (op.xtype, op.ytype, op.ztype)):
        raise TypeError(f"the JAX user-defined op {op.name} is not carried "
                        f"(its body is JAX code); build the port's op")
    out = binary[op.name.lower()][type_by_name(op.xtype.name)]
    if (out.ytype.name, out.ztype.name) != (op.ytype.name, op.ztype.name):
        raise TypeError(f"no builtin binary op {op.name} of types "
                        f"({op.xtype.name}, {op.ytype.name}) -> "
                        f"{op.ztype.name}")
    return out


def _host_scalar(x):
    """A JAX-side scalar (Python, numpy or a device array; a dict of
    them for a user-defined type) on the host."""
    return tree_map(lambda v: np.asarray(v)[()], x)


def _pending_from_jax(pending):
    """A JAX container's pending list with host scalars and the port's
    accum ops; a bitmap index comes as a tuple of ints."""
    out = []
    for *idx, x, op in pending:
        if len(idx) == 1:     # the bitmap form: (index, scalar, accum)
            idx = [tuple(int(i) for i in np.atleast_1d(idx[0]))]
        else:                 # the sparse form: (i, j, scalar, accum)
            idx = [int(i) for i in idx]
        out.append((*idx, _host_scalar(x), _accum_of(op)))
    return as_pending(out)


def _host_values(values):
    """A JAX container's values (a dict of arrays for a user-defined
    type) as host arrays."""
    return tree_map(np.asarray, values)


def from_jax(obj, device=None):
    """The port's counterpart of a JAX package CsrMatrix, CscMatrix,
    HyperMatrix, HyperCscMatrix, SparseVec, bitmap Matrix, Vector (each
    with its pending tuples), BandPlan,
    WindowPlan, TilePattern, BSR SpMV plan (read through numpy) or
    builtin Semiring (by name)."""
    kind = type(obj).__name__
    if kind == "tuple" and len(obj) == 8:
        return bsr_spmv_plan_from_arrays(*(np.asarray(a) for a in obj[:5]),
                                         *obj[5:], device=device)
    if kind == "Semiring":
        sr = semiring_by_name(obj.add.op.name, obj.mult.name,
                              obj.mult.xtype.name)
        if sr.ztype.name != obj.add.type.name:
            raise TypeError(f"no builtin semiring matches {obj.name}")
        return sr
    if kind == "CsrMatrix":
        hp = obj._options.get("host_pattern")
        A = csr_from_arrays(
            np.asarray(obj.indptr), np.asarray(obj.indices),
            np.asarray(obj.rowids), _host_values(obj.values), obj.nvals,
            obj.nrows, obj.ncols, type_from_jax(obj.type), hp, device)
        A._pending = _pending_from_jax(obj._pending)
        return A
    if kind == "CscMatrix":
        return CscMatrix(from_jax(obj.tr, device))
    if kind == "HyperMatrix":
        A = hyper_from_arrays(
            np.asarray(obj.h), np.asarray(obj.hptr), np.asarray(obj.rowids),
            np.asarray(obj.indices), _host_values(obj.values), obj.nvals,
            obj.nvec, obj.nrows, obj.ncols, type_from_jax(obj.type), device)
        A._pending = _pending_from_jax(obj._pending)
        A._options.update(obj._options)
        return A
    if kind == "HyperCscMatrix":
        return HyperCscMatrix(from_jax(obj.tr, device))
    if kind == "SparseVec":
        return SparseVec(from_jax(obj.hm, device))
    if kind in ("Matrix", "Vector"):
        make = matrix_from_arrays if kind == "Matrix" else vector_from_arrays
        X = make(_host_values(obj.values), np.asarray(obj.pattern),
                 type_from_jax(obj.type), device)
        X._pending = _pending_from_jax(obj._pending)
        return X
    if kind == "BandPlan":
        return band_plan_from_arrays(
            np.asarray(obj.P), np.asarray(obj.Ut), obj.nI, obj.Wb,
            obj.ntriples, obj.nedges, device)
    if kind == "WindowPlan":
        return window_plan_from_arrays(
            np.asarray(obj.P), np.asarray(obj.Q), np.asarray(obj.M),
            obj.nI, obj.Wmax, obj.nJmax, obj.k0, obj.j0, obj.ntriples,
            obj.shape, obj.mshape, device)
    if kind == "TilePattern":
        return tile_pattern_from_arrays(obj.tiles, obj.grid, obj.index,
                                        obj.shape, obj.T, device)
    raise TypeError(f"cannot convert a {kind}")
