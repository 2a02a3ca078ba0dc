"""Triangle counting through the GraphBLAS operations: the reference's
``tri_demo`` flow.

Counterpart of ``graphblas_tpu/models/tricount.py``.  Reference
``Demo/Source/tricount.c``: six methods over a symmetric binary
adjacency matrix A (E = edge incidence, L = tril(A), U = triu(A)):

  0 minitri:   ntri = nnz(A*E == 2) / 3
  1 Burkhardt: ntri = sum(sum((A*A) .* A)) / 6
  2 Cohen:     ntri = sum(sum((L*U) .* A)) / 2
  3 Sandia:    ntri = sum(sum((L*L) .* L))
  4 Sandia2:   ntri = sum(sum((U*U) .* U))
  5 SandiaDot: ntri = sum(sum((L*U') .* L))   (dot-product method)

Each ".*" is the mxm mask argument, as in the reference; ``tricount_prep``
builds L and U with ``select`` (tril/triu).  Outputs are made in A's
kind of container on A's device: a bitmap ``Matrix`` for a graph that
fits one (what the JAX package uses), a ``CsrMatrix`` for a large one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.descriptor import TRAN1
from ..core.monoids import monoid
from ..core.ops import UnaryOp, select as selectops
from ..core.semirings import semiring
from ..core.types import INT64, UINT32
from ..ops.containers import new_like
from ..ops.ewise import apply as gb_apply, select as gb_select
from ..ops.mxm import mxm
from ..ops.reduce import reduce_to_scalar

__all__ = ["tricount", "tricount_prep", "edge_incidence", "METHODS"]

METHODS = ("minitri", "Burkhardt", "Cohen", "Sandia", "Sandia2", "SandiaDot")

# z = (x == 2), the minitri test of an (vertex, edge) count
_TWO = UnaryOp("TWO", lambda x: (x == 2).to(torch.int32), UINT32, UINT32)


def tricount_prep(A) -> Tuple:
    """L = tril(A, -1), U = triu(A, 1) via GxB_select (``tri_demo.c``)."""
    n = A.nrows
    L = gb_select(new_like(A, A.type, n, n), None, None, selectops.tril,
                  A, -1)
    U = gb_select(new_like(A, A.type, n, n), None, None, selectops.triu,
                  A, 1)
    return L, U


def edge_incidence(A):
    """E: n x ne edge incidence matrix of the undirected graph A (for
    minitri; the ``tricount.m`` definition: column e has 1s at both
    endpoints of edge e, one column per upper-triangular edge, in
    row-major order of the upper triangle).  A's pattern is read on the
    host, as the JAX package reads it."""
    I, J, _ = A.extractTuples()
    up = I < J
    iu, ju = I[up], J[up]
    order = np.lexsort((ju, iu))
    iu, ju = iu[order], ju[order]
    ne = len(iu)
    e = np.arange(ne)
    I = np.concatenate([iu, ju])
    J = np.concatenate([e, e])
    X = np.ones(2 * ne, np.uint32)
    return type(A).from_coo(I, J, X, A.nrows, ne, type=UINT32,
                            device=A.device)


def tricount(method, A=None, E=None, L=None, U=None) -> int:
    """The number of triangles by the named or numbered method
    (reference ``tricount.c:75-191``)."""
    if isinstance(method, str):
        method = METHODS.index(method)
    plus_times = semiring.plus_times[UINT32]
    plus_int64 = monoid.plus[INT64]

    def count(X) -> int:
        return int(reduce_to_scalar(None, plus_int64, X))

    if method == 0:       # minitri
        if E is None:
            E = edge_incidence(A)
        n, ne = A.nrows, E.ncols
        C = mxm(new_like(A, UINT32, n, ne), None, None, plus_times, A, E)
        S = gb_apply(new_like(A, UINT32, n, ne), None, None, _TWO, C)
        return count(S) // 3
    if method == 1:       # Burkhardt: (A*A) .* A
        C = mxm(new_like(A, UINT32, A.nrows, A.nrows), A, None, plus_times,
                A, A)
        return count(C) // 6
    if method == 2:       # Cohen: (L*U) .* A
        C = mxm(new_like(A, UINT32, A.nrows, A.nrows), A, None, plus_times,
                L, U)
        return count(C) // 2
    if method == 3:       # Sandia: (L*L) .* L
        C = mxm(new_like(L, UINT32, L.nrows, L.nrows), L, None, plus_times,
                L, L)
        return count(C)
    if method == 4:       # Sandia2: (U*U) .* U
        C = mxm(new_like(U, UINT32, U.nrows, U.nrows), U, None, plus_times,
                U, U)
        return count(C)
    if method == 5:       # SandiaDot: (L*U') .* L
        C = mxm(new_like(L, UINT32, U.nrows, U.nrows), L, None, plus_times,
                L, U, TRAN1)
        return count(C)
    raise ValueError(f"invalid tricount method {method}")
