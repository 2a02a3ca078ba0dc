"""Kronecker graph generation (reference ``Extras/ExactKronGen``).

Counterpart of ``graphblas_tpu/models/kron.py``.  The reference's MPI
program gives each rank a contiguous slice of A's tuples, computes
``GxB_kron(my_A, B)`` locally and writes its block, with no
communication between ranks (``kron_mpi.c:56-96``,
``kron_submatrix.c:138-141``).  Here the shards are slices of A's tuple
list, each a pure tuple computation: tuple (ia, ja, xa) of A and tuple
(ib, jb, xb) of B give the entry (ia*bm + ib, ja*bn + jb, xa*xb) of C.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.matrix import Matrix
from ..core.ops import BinaryOp, binary
from ..core.types import FP64

__all__ = ["kron_tuples", "kron_submatrix", "kron_generate"]


def kron_tuples(IA, JA, XA, IB, JB, XB, bm: int, bn: int,
                op: Optional[BinaryOp] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All |A|*|B| Kronecker tuples, vectorized on the host (the
    per-shard compute); values as float64.  ``op`` is the GxB_kron
    multiply operator (default TIMES), applied to float64 tensors."""
    IA = np.asarray(IA, np.int64)[:, None]
    JA = np.asarray(JA, np.int64)[:, None]
    XA = np.asarray(XA, np.float64)[:, None]
    IB = np.asarray(IB, np.int64)[None, :]
    JB = np.asarray(JB, np.int64)[None, :]
    XB = np.asarray(XB, np.float64)[None, :]
    I = (IA * bm + IB).reshape(-1)
    J = (JA * bn + JB).reshape(-1)
    if op is None or op.name == "TIMES":
        X = (XA * XB).reshape(-1)
    else:
        shape = (XA.shape[0], XB.shape[1])
        X = np.asarray(op(torch.from_numpy(np.broadcast_to(XA, shape).copy()),
                          torch.from_numpy(np.broadcast_to(XB, shape).copy()))
                       ).reshape(-1)
    return I, J, X


def kron_submatrix(IA, JA, XA, IB, JB, XB, bm: int, bn: int,
                   pid: int, np_: int, op: Optional[BinaryOp] = None):
    """The pid-th of np_ shards: A's tuples sliced contiguously
    (``kron_submatrix.c:138-141``) and expanded against all of B."""
    ntuples = len(IA)
    lo = (pid * ntuples) // np_
    hi = ((pid + 1) * ntuples) // np_
    return kron_tuples(IA[lo:hi], JA[lo:hi], XA[lo:hi], IB, JB, XB,
                       bm, bn, op=op)


def kron_generate(A: Matrix, B: Matrix, nshards: int = 1,
                  op: Optional[BinaryOp] = None) -> Matrix:
    """C = kron(A, B) by the sharded tuple expansion, as an FP64 bitmap
    Matrix on A's device; with nshards > 1 the shards are computed apart
    and concatenated, equal to the MPI reference's gathered output."""
    IA, JA, XA = A.extractTuples()
    IB, JB, XB = B.extractTuples()
    bm, bn = B.nrows, B.ncols
    parts = [kron_submatrix(IA, JA, XA, IB, JB, XB, bm, bn, p, nshards,
                            op=op)
             for p in range(nshards)]
    I = np.concatenate([p[0] for p in parts])
    J = np.concatenate([p[1] for p in parts])
    X = np.concatenate([p[2] for p in parts])
    return Matrix.from_coo(I, J, X, A.nrows * bm, A.ncols * bn, type=FP64,
                           dup=binary.plus[FP64], device=A.device)
