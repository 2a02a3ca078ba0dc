"""Breadth-first search, level labelling.

Counterpart of ``graphblas_tpu/models/bfs.py``.  Reference algorithms
(re-expressed on this framework's API, not ported):

* ``Demo/Source/bfs5m.c`` — the "vector assign & reduce" formulation:
  per level, ``v<q> = level`` (masked assign), ``q<!v> = q ||.&& A``
  (vxm over the LOR-LAND semiring with complemented mask + REPLACE),
  stop when ``reduce(q, LOR)`` finds no successor.
* ``Demo/Source/bfs6.c`` — the "apply" formulation: v accumulates
  level*q via apply + eWise add.
* ``Demo/Source/bfs_level.c`` — single-step level update used by bfs6.

The *_check variants (``bfs5m_check.c`` / ``bfs6_check.c``) differ only
by error checking in C; here errors are exceptions, so one
implementation serves both — aliases are exported for API parity.

A takes any matrix container: a bitmap ``Matrix`` runs each level's
``vxm`` as a dense product, a ``CsrMatrix`` or ``CscMatrix`` as an SpMV
(the sparse-x engine of :mod:`graphblas_tpu_torch.sparse.spmv`).  A
``CsrMatrix`` is turned once into its by-column twin, whose stored
arrays are A' in CSR, so the levels' ``vxm`` (u'A = A'u) resort nothing;
the output is the same.  The vectors are bitmap ``Vector`` containers
on A's device.  The per-level ``bool(reduce_to_scalar(...))`` is the
loop's one read-back.  ``bfs_jit`` is the whole loop on the bitmap
pattern's device, reading back one bool a level where the JAX package
runs one ``lax.while_loop``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.descriptor import Descriptor
from ..core.matrix import Matrix, Vector
from ..core.monoids import monoid
from ..core.ops import UnaryOp, binary
from ..core.semirings import semiring
from ..core.types import BOOL, INT32
from ..ops.assign import assign_vector
from ..ops.ewise import apply as gb_apply
from ..ops.mxm import vxm
from ..ops.reduce import reduce_to_scalar

__all__ = ["bfs5m", "bfs6", "bfs", "bfs_level", "bfs_jit",
           "bfs5m_check", "bfs6_check"]

_SR_DESC = Descriptor(mask_scmp=True, replace=True)


def vxm_operand(A):
    """A in the orientation ``vxm`` reads without a resort: a CsrMatrix
    as its by-column twin (one transpose, once), any other container as
    it is."""
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(A, CsrMatrix):
        return CscMatrix(A.T())
    return A.wait()


def bfs5m(A, s: int) -> Vector:
    """BFS levels via masked assign + vxm (reference ``bfs5m.c:33-95``).

    v[i] = level of node i (1 for the source); unreachable nodes have no
    entry.
    """
    n = A.nrows
    dev = A.device
    Aop = vxm_operand(A)
    v = Vector.from_dense(np.zeros(n, np.int32), INT32, device=dev)
    q = Vector.new(BOOL, n, device=dev).setElement(True, s)
    boolean = semiring.lor_land[BOOL]
    lor = monoid.lor[BOOL]

    successor = True
    level = 1
    while successor and level <= n:
        # v<q> = level
        v = assign_vector(v, q, None, level, None, None, scalar=True)
        # q<!v> = q ||.&& A   (complemented mask: v!=0 marks visited)
        q = vxm(q, v, None, boolean, q, Aop, _SR_DESC)
        # successor = ||(q)
        successor = bool(reduce_to_scalar(None, lor, q))
        level += 1

    # make v sparse: v<v> = v with REPLACE (drops the explicit zeros)
    return assign_vector(v, v, None, v, None, Descriptor(replace=True))


def bfs_level(v: Vector, q: Vector, level: int) -> Vector:
    """One level update v += level*q (reference ``bfs_level.c``:
    apply with a level-binding unary op)."""
    op = UnaryOp(f"LEVEL{level}", lambda x: torch.full_like(
        x, level, dtype=torch.int32), INT32, BOOL)
    return gb_apply(v, None, binary.plus[INT32], op, q, None)


def bfs6(A, s: int) -> Vector:
    """BFS via apply (reference ``bfs6.c``): v accumulates level masks."""
    n = A.nrows
    dev = A.device
    Aop = vxm_operand(A)
    v = Vector.new(INT32, n, device=dev)
    q = Vector.new(BOOL, n, device=dev).setElement(True, s)
    boolean = semiring.lor_land[BOOL]
    lor = monoid.lor[BOOL]
    anyq = True
    level = 1
    while anyq and level <= n:
        v = bfs_level(v, q, level)
        # q<!v> = q ||.&& A
        q = vxm(q, v, None, boolean, q, Aop, _SR_DESC)
        anyq = bool(reduce_to_scalar(None, lor, q))
        level += 1
    return v


# checked variants: identical here (errors are exceptions)
bfs5m_check = bfs5m
bfs6_check = bfs6
bfs = bfs5m


def bfs_jit(A: Matrix, s: int) -> np.ndarray:
    """The whole BFS loop on the bitmap pattern (the JAX package's
    ``lax.while_loop`` form): int32 levels, 0 = unreachable.  Each level
    is one dense float32 product of the frontier with the pattern
    (counts below 2^24 are exact), and the loop reads back one bool a
    level to stop."""
    A = A.wait()
    n = A.nrows
    dev = A.device
    Af = A.pattern.to(torch.float32)
    v = torch.zeros(n, dtype=torch.int32, device=dev)
    q = torch.zeros(n, dtype=torch.bool, device=dev)
    q[s] = True
    level = 1
    while level <= n and bool(q.any()):
        v = torch.where(q, level, v)
        # frontier = q OR.AND A, masked by unvisited
        nxt = (q.to(torch.float32)[None, :] @ Af)[0] > 0
        q = nxt & (v == 0)
        level += 1
    return v.cpu().numpy()
