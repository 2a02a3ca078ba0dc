"""k-truss and all-k-truss decomposition through the GraphBLAS
operations.

Counterpart of ``graphblas_tpu/models/ktruss.py``.  Reference:
``Extras/ktruss/ktruss_graphblas.c`` (C_k = the largest subgraph whose
every edge is in >= k-2 triangles of C_k: iterate ``C<C> = C*C
(plus_land)``, then prune entries with support < k-2, until the edge
count stops changing) and ``Extras/ktruss/allktruss.c`` (sweep k = 3..
until the truss is empty, starting each k from the (k-1)-truss).

Each sweep is one masked ``mxm`` and one ``select``.  The outputs are
made in A's kind of container on A's device: a bitmap ``Matrix`` (the
JAX package's) or a ``CsrMatrix``, whose products run the sparse
engines.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.matrix import Matrix
from ..core.ops import SelectOp
from ..core.semirings import semiring
from ..core.types import INT64
from ..ops.containers import new_like
from ..ops.ewise import select as gb_select
from ..ops.mxm import mxm

__all__ = ["ktruss", "allktruss", "SUPPORT"]

#: the user select op of ``ktruss_graphblas.c`` (its support_function):
#: keep the entries whose support is at least the thunk
SUPPORT = SelectOp("SUPPORT", lambda i, j, x, k: x >= k)


def _nvals(X) -> int:
    return X.nvals() if isinstance(X, Matrix) else X.nvals


def _sweep(C, support: int):
    """One k-truss step: T<C> = C*C over plus_land, then prune."""
    n = C.nrows
    T = mxm(new_like(C, INT64, n, n), C, None, semiring.plus_land[INT64],
            C, C)
    return gb_select(new_like(C, INT64, n, n), None, None, SUPPORT, T,
                     support)


def ktruss(A, k: int, max_steps: Optional[int] = None) -> Tuple[object, int]:
    """(C, nsteps): the k-truss of the symmetric boolean matrix A.

    C(i, j) = the number of triangles of the truss that the surviving
    edge (i, j) is in."""
    if k < 3:
        raise ValueError("k must be >= 3")
    last_cnz = _nvals(A)
    C = A
    nsteps = 0
    while True:
        nsteps += 1
        C = _sweep(C, k - 2)
        cnz = _nvals(C)
        if cnz == last_cnz or (max_steps and nsteps >= max_steps):
            return C, nsteps
        last_cnz = cnz


def allktruss(A, kmax: Optional[int] = None) -> Dict[int, Dict[str, int]]:
    """The all-k-truss sweep (reference ``allktruss.c``): statistics per
    k until the truss vanishes.  Returns {k: {nedges, nsteps, nt}}."""
    out: Dict[int, Dict[str, int]] = {}
    C = A
    k = 3
    last_cnz = _nvals(A)
    while kmax is None or k <= kmax:
        nsteps = 0
        while True:
            nsteps += 1
            C = _sweep(C, k - 2)
            cnz = _nvals(C)
            if cnz == last_cnz:
                break
            last_cnz = cnz
        total = int(C.values.sum(dtype=torch.int64))
        out[k] = {"nedges": cnz // 2, "nsteps": nsteps, "nt": total // 6}
        if cnz == 0:
            break
        k += 1
    return out
