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
8-tuple ``bsr_spmv_plan`` returns).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.matrix import Matrix, Vector
from .core.semirings import Semiring, semiring
from .core.types import type_by_name
from .sparse.bsr import TilePattern
from .sparse.container import CscMatrix, CsrMatrix, resolve_device
from .sparse.cuda_spmv import BsrSpmvPlan
from .sparse.window import BandPlan, WindowPlan

__all__ = ["csr_from_arrays", "matrix_from_arrays", "vector_from_arrays",
           "band_plan_from_arrays", "window_plan_from_arrays",
           "bsr_spmv_plan_from_arrays", "tile_pattern_from_arrays",
           "semiring_by_name", "from_jax"]


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def csr_from_arrays(indptr, indices, rowids, values, nvals: int,
                    nrows: int, ncols: int, type_name: str,
                    host_pattern=None, device=None) -> CsrMatrix:
    """CsrMatrix from the padded arrays of the same layout."""
    device = resolve_device(device)
    t = type_by_name(type_name)
    A = CsrMatrix(_dev(np.asarray(indptr, np.int32), device),
                  _dev(np.asarray(indices, np.int32), device),
                  _dev(np.asarray(rowids, np.int32), device),
                  _dev(t.to_storage(values), device),
                  nvals, nrows, ncols, t)
    if host_pattern is not None:
        A._options["host_pattern"] = (np.asarray(host_pattern[0]),
                                      np.asarray(host_pattern[1]))
    return A


def matrix_from_arrays(values, pattern, type_name: str,
                       device=None) -> Matrix:
    """Bitmap Matrix from its values and pattern."""
    device = resolve_device(device)
    t = type_by_name(type_name)
    return Matrix(_dev(t.to_storage(values), device),
                  _dev(np.asarray(pattern, bool), device), t)


def vector_from_arrays(values, pattern, type_name: str,
                       device=None) -> Vector:
    """Bitmap Vector from its values and pattern."""
    device = resolve_device(device)
    t = type_by_name(type_name)
    return Vector(_dev(t.to_storage(values), device),
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


def from_jax(obj, device=None):
    """The port's counterpart of a JAX package CsrMatrix, CscMatrix,
    bitmap Matrix (its pending tuples folded first), Vector, BandPlan,
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
        return csr_from_arrays(
            np.asarray(obj.indptr), np.asarray(obj.indices),
            np.asarray(obj.rowids), np.asarray(obj.values), obj.nvals,
            obj.nrows, obj.ncols, obj.type.name, hp, device)
    if kind == "CscMatrix":
        return CscMatrix(from_jax(obj.tr, device))
    if kind == "Matrix":
        obj = obj.wait()
        return matrix_from_arrays(np.asarray(obj.values),
                                  np.asarray(obj.pattern), obj.type.name,
                                  device)
    if kind == "Vector":
        return vector_from_arrays(np.asarray(obj.values),
                                  np.asarray(obj.pattern), obj.type.name,
                                  device)
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
