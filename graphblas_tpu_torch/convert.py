"""Build the port's containers and plans from the JAX package's, through
numpy arrays only (this module imports no JAX).

A JAX-side object is read attribute by attribute with ``np.asarray``, so
both packages can count on exactly the same containers and plans — the
parity tests' "weights".  Each ``*_from_arrays`` function takes plain
arrays and metadata; :func:`from_jax` reads them off a JAX package
``CsrMatrix``, ``BandPlan`` or ``WindowPlan``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import type_by_name
from .sparse.container import CsrMatrix, default_device
from .sparse.window import BandPlan, WindowPlan

__all__ = ["csr_from_arrays", "band_plan_from_arrays",
           "window_plan_from_arrays", "from_jax"]


def _dev(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def csr_from_arrays(indptr, indices, rowids, values, nvals: int,
                    nrows: int, ncols: int, type_name: str,
                    host_pattern=None, device=None) -> CsrMatrix:
    """CsrMatrix from the padded arrays of the same layout."""
    device = default_device() if device is None else torch.device(device)
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


def band_plan_from_arrays(P, Ut, nI: int, Wb: int, ntriples: int,
                          nedges: int, device=None) -> BandPlan:
    device = default_device() if device is None else torch.device(device)
    return BandPlan(_dev(np.asarray(P, np.int8), device),
                    _dev(np.asarray(Ut, np.int8), device),
                    nI, Wb, ntriples, nedges)


def window_plan_from_arrays(P, Q, M, nI: int, Wmax: int, nJmax: int, k0,
                            j0, ntriples: int, shape, mshape,
                            device=None) -> WindowPlan:
    device = default_device() if device is None else torch.device(device)
    return WindowPlan(_dev(np.asarray(P, np.int8), device),
                      _dev(np.asarray(Q, np.int8), device),
                      _dev(np.asarray(M, np.int8), device),
                      nI, Wmax, nJmax, np.asarray(k0), np.asarray(j0),
                      ntriples, tuple(shape), tuple(mshape))


def from_jax(obj, device=None):
    """The port's counterpart of a JAX package CsrMatrix, BandPlan or
    WindowPlan (read through numpy)."""
    kind = type(obj).__name__
    if kind == "CsrMatrix":
        hp = obj._options.get("host_pattern")
        return csr_from_arrays(
            np.asarray(obj.indptr), np.asarray(obj.indices),
            np.asarray(obj.rowids), np.asarray(obj.values), obj.nvals,
            obj.nrows, obj.ncols, obj.type.name, hp, device)
    if kind == "BandPlan":
        return band_plan_from_arrays(
            np.asarray(obj.P), np.asarray(obj.Ut), obj.nI, obj.Wb,
            obj.ntriples, obj.nedges, device)
    if kind == "WindowPlan":
        return window_plan_from_arrays(
            np.asarray(obj.P), np.asarray(obj.Q), np.asarray(obj.M),
            obj.nI, obj.Wmax, obj.nJmax, obj.k0, obj.j0, obj.ntriples,
            obj.shape, obj.mshape, device)
    raise TypeError(f"cannot convert a {kind}")
