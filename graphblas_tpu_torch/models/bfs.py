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
``CsrMatrix`` is turned once a call into its by-column twin, whose
stored arrays are A' in CSR (``CsrMatrix.T``, a device sort), so the
levels' ``vxm`` (u'A = A'u) resort nothing; the output is the same.
The vectors are bitmap ``Vector`` containers on A's device.  A level
reads back once (``gb.read.reduce_scalar``): the successor flag of
``reduce_to_scalar`` and, in the same copy, whether the frontier is
full, which the next level's ``vxm`` asks to choose its engine; the
first level's ``vxm`` reads that itself (``gb.read.all_present``).
``bfs5m`` and ``bfs6`` are the spans ``gb.entry.bfs5m`` and
``gb.entry.bfs6``.  ``bfs_jit`` is the whole loop on the bitmap
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
from ..utils import counters

__all__ = ["bfs5m", "bfs6", "bfs", "bfs_level", "bfs_jit",
           "bfs5m_check", "bfs6_check"]

_SR_DESC = Descriptor(mask_scmp=True, replace=True)


def vxm_operand(A):
    """A in the orientation ``vxm`` reads without a resort: a CsrMatrix
    as its by-column twin (one device transpose), any other container
    as it is."""
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(A, CsrMatrix):
        return CscMatrix(A.T())
    return A.wait()


@counters.spanned("gb.entry.bfs5m")
def bfs5m(A, s: int) -> Vector:
    """BFS levels via masked assign + vxm (reference ``bfs5m.c:33-95``).

    v[i] = level of node i (1 for the source); unreachable nodes have no
    entry.  Each level's assign is issued before the previous level's
    successor flag is read, so the card has it queued while the host
    waits; after the last level it assigns through an empty frontier,
    which changes nothing.
    """
    n = A.nrows
    dev = A.device
    Aop = vxm_operand(A)
    v = Vector.from_dense(torch.zeros(n, dtype=torch.int32, device=dev),
                          INT32)
    q = Vector.new(BOOL, n, device=dev).setElement(True, s).wait()
    boolean = semiring.lor_land[BOOL]
    lor = monoid.lor[BOOL]

    # v<q> = level
    v = assign_vector(v, q, None, 1, None, None, scalar=True)
    successor = True
    level = 1
    while successor and level <= n:
        # q<!v> = q ||.&& A   (complemented mask: v!=0 marks visited)
        q = vxm(q, v, None, boolean, q, Aop, _SR_DESC)
        level += 1
        # the next level's v<q> = level, then successor = ||(q)
        v = assign_vector(v, q, None, level, None, None, scalar=True)
        successor = bool(reduce_to_scalar(None, lor, q))

    # make v sparse: v<v> = v with REPLACE (drops the explicit zeros)
    return assign_vector(v, v, None, v, None, Descriptor(replace=True))


def bfs_level(v: Vector, q: Vector, level: int) -> Vector:
    """One level update v += level*q (reference ``bfs_level.c``:
    apply with a level-binding unary op)."""
    op = UnaryOp(f"LEVEL{level}", lambda x: torch.full_like(
        x, level, dtype=torch.int32), INT32, BOOL)
    return gb_apply(v, None, binary.plus[INT32], op, q, None)


@counters.spanned("gb.entry.bfs6")
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
