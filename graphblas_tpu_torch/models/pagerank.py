"""PageRank, mirroring the reference demos:

* :func:`dpagerank`  — fp64 plus-times iteration (``Demo/Source/dpagerank.c``)
* :func:`ipagerank`  — uint64 scaled-integer arithmetic (``ipagerank.c``)
* :func:`pagerank_jit` — the whole loop on the row-scaled values

Counterpart of ``graphblas_tpu/models/pagerank.py``.  Each iteration is
a ``vxm`` on the bitmap ``Matrix`` (the dense engines of
``semiring_mm``: a float64 matmul for FP64, the exact 16-bit-limb route
for ``plus_times[UINT64]``, which wraps mod 2^64 on the port's signed
storage as uint64 does).  As in the JAX package, the models take a
bitmap ``Matrix``: the row scaling reads A's dense pattern, so a
``CsrMatrix`` raises.  ``dpagerank2`` (the PageRank semiring on a
user-defined struct type, ``dpagerank2.c``) waits for user-defined types
(ROADMAP.md queue 1, item 7) and raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.matrix import Matrix, Vector
from ..core.monoids import monoid
from ..core.ops import UnaryOp, binary
from ..core.semirings import semiring
from ..core.types import FP64, UINT64, cast
from ..ops.assign import assign_vector
from ..ops.containers import UnsupportedContainer
from ..ops.ewise import apply as gb_apply
from ..ops.mxm import vxm
from ..ops.reduce import reduce_to_scalar, reduce_to_vector

__all__ = ["drowscale", "irowscale", "dpagerank", "ipagerank",
           "dpagerank2", "dpagerank2_csr", "pagerank_jit"]

ZSCALE = np.uint64(1) << np.uint64(30)


def _bitmap(A, what: str) -> Matrix:
    if not isinstance(A, Matrix):
        raise UnsupportedContainer(
            f"{what}: takes a bitmap Matrix, as the JAX package's does "
            f"(the row scaling reads A's dense pattern); got "
            f"{type(A).__name__} (build the graph with Matrix.from_coo, or "
            f"use sparse.pagerank_csr on a CsrMatrix)")
    return A.wait()


def drowscale(A: Matrix) -> Matrix:
    """C = D*A where D(i,i)=1/sum(A(i,:)) (reference ``drowscale.c``)."""
    A = _bitmap(A, "drowscale")
    dout = reduce_to_vector(Vector.new(FP64, A.nrows, device=A.device),
                            None, None, monoid.plus[FP64], A)
    vals = (A.pattern.to(torch.float64) if A.type.is_bool
            else cast(A.values, FP64, A.type))
    rowsum = torch.where(dout.pattern & (dout.values != 0), dout.values,
                         1.0)
    scaled = vals / rowsum[:, None]
    return Matrix(torch.where(A.pattern, scaled, 0.0), A.pattern, FP64)


def irowscale(A: Matrix) -> Matrix:
    """uint64 rowscale: C(i,j) = ZSCALE / degree(i) on the pattern
    (reference ``irowscale.c``)."""
    A = _bitmap(A, "irowscale")
    deg = A.pattern.sum(dim=1, dtype=torch.int64)
    safe = torch.where(deg == 0, 1, deg)
    c = (int(ZSCALE) // safe)[:, None]
    vals = torch.where(A.pattern, c.expand(A.pattern.shape), 0)
    return Matrix(vals, A.pattern, UINT64)


def _crand_stream(n: int, seed: int) -> np.ndarray:
    """glibc rand() clone (TYPE_3 additive feedback) so dpagerank's
    ``srand((int) n)`` initial ranks reproduce the reference bit-for-bit.

    glibc uses the classic additive generator: r[i] = r[i-3] + r[i-31]
    (mod 2^32), output r[i] >> 1, with the documented LCG warm-up.
    """
    r = np.zeros(344 + n, dtype=np.uint32)
    r[0] = np.uint32(seed)
    with np.errstate(over="ignore"):
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647, signed-safe form
            hi, lo = divmod(int(r[i - 1]), 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = np.uint32(word)
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344 + n):
            r[i] = r[i - 3] + r[i - 31]
    return (r[344:] >> np.uint32(1)).astype(np.int64)


def dpagerank(A: Matrix, iters: int = 20,
              seed: Optional[int] = None) -> List[Tuple[int, float]]:
    """fp64 PageRank (reference ``dpagerank.c``); returns [(page, rank)]
    sorted by descending rank.  damping c=0.85, 20 fixed iterations,
    random init from srand(n) (glibc stream clone for parity)."""
    A = _bitmap(A, "dpagerank")
    n = A.nrows
    c = 0.85
    rstream = _crand_stream(n, seed if seed is not None else n)
    r0 = rstream.astype(np.float64) / 2147483647.0  # RAND_MAX
    r = Vector.from_dense(r0, FP64, device=A.device)
    a = (1.0 - c) / n
    C = drowscale(A)
    plus_times = semiring.plus_times[FP64]
    op_scale = UnaryOp("FSCALE", lambda x: c * x, FP64, FP64)

    for _ in range(iters):
        s = a * float(reduce_to_scalar(None, monoid.plus[FP64], r))
        r = gb_apply(r, None, None, op_scale, r)                 # r = c*r
        r = vxm(r, None, None, plus_times, r, C)                 # r = r*C
        r = assign_vector(r, None, binary.plus[FP64], s, None,   # r += s
                          None, scalar=True)
    s = float(reduce_to_scalar(None, monoid.plus[FP64], r))
    r = gb_apply(r, None, None,
                 UnaryOp("FDIV", lambda x: x / s, FP64, FP64), r)
    I, X = r.extractTuples()
    order = np.argsort(-X, kind="stable")
    return [(int(I[k]), float(X[k])) for k in order]


def _udiv_zscale(v: torch.Tensor) -> torch.Tensor:
    """max(v // ZSCALE, 1) for uint64 values in int64 storage (a logical
    shift: the quotient is below 2^34)."""
    return ((v >> 30) & ((1 << 34) - 1)).clamp(min=1)


def ipagerank(A: Matrix, iters: int = 20,
              seed: Optional[int] = None) -> List[Tuple[int, int]]:
    """uint64 scaled-integer PageRank (reference ``ipagerank.c``):
    ic = 912680550 ~= 0.85 * 2^30; division guards against underflow."""
    A = _bitmap(A, "ipagerank")
    n = A.nrows
    ic = np.uint64(912680550)
    RMAX = np.uint64(2147483648)  # RAND_MAX + 1
    rstream = _crand_stream(n, seed if seed is not None else n)
    x = rstream.astype(np.uint64)
    # scale rand() into [0, 2*ZSCALE) then / n (ipagerank.c:111-127)
    two_z = np.uint64(2) * ZSCALE
    if two_z > RMAX:
        x = x * (two_z // RMAX)
    elif two_z < RMAX:
        # bug-compatible with the reference: C's `x / (RMAX / 2*ZSCALE)`
        # parses as x / ((RMAX/2)*ZSCALE) (ipagerank.c:121-126); the
        # branch is dead at the default ZSCALE=2^30 where 2*ZSCALE==RMAX
        x = x // (RMAX // np.uint64(2) * ZSCALE)
    x = x // np.uint64(n)
    x = np.where(x == 0, np.uint64(1), x)
    r = Vector.from_dense(x, UINT64, device=A.device)
    ia = (ZSCALE - ic) // np.uint64(n)
    if ia == 0:
        ia = np.uint64(1)
    C = irowscale(A)
    plus_times = semiring.plus_times[UINT64]
    # uint64 products wrap mod 2^64 in the int64 storage as in C
    op_scale = UnaryOp("ISCALE", lambda v: v * int(ic), UINT64, UINT64)
    op_div = UnaryOp("IDIV", _udiv_zscale, UINT64, UINT64)

    for _ in range(iters):
        with np.errstate(over="ignore"):
            s = np.uint64(reduce_to_scalar(None, monoid.plus[UINT64],
                                           r)) * ia
        r = gb_apply(r, None, None, op_scale, r)   # r = ic * r
        r = gb_apply(r, None, None, op_div, r)     # r = r / ZSCALE
        r = vxm(r, None, None, plus_times, r, C)   # r = r * C
        r = assign_vector(r, None, binary.plus[UINT64], s, None,
                          None, scalar=True)       # r += s
        r = gb_apply(r, None, None, op_div, r)     # r = r / ZSCALE
    I, X = r.extractTuples()
    order = np.argsort(-X.astype(np.uint64), kind="stable")
    return [(int(I[k]), int(X[k])) for k in order]


def _udt_unported(what: str):
    from ..core.resolve import UnsupportedOp
    raise UnsupportedOp(
        f"{what}: the PageRank semiring runs on a user-defined struct "
        f"type, which comes with a later slice of the port (ROADMAP.md "
        f"queue 1, item 7); use dpagerank")


def dpagerank2(A, itermax: int = 100, tol: float = 1e-5):
    """PageRank via a user-defined semiring (``dpagerank2.c``): waits for
    user-defined types."""
    _udt_unported("dpagerank2")


def dpagerank2_csr(A, itermax: int = 100, tol: float = 1e-5):
    """:func:`dpagerank2` on a CsrMatrix: waits for user-defined types."""
    _udt_unported("dpagerank2_csr")


def pagerank_jit(A: Matrix, iters: int = 20) -> np.ndarray:
    """PageRank as one loop on the row-scaled dense values (the JAX
    package's one-compile form): r <- 0.85 r C + 0.15/n sum(r) from
    r = 1/n; returns the normalized rank vector."""
    C = drowscale(A)
    n = C.nrows
    r = torch.full((n,), 1.0 / n, dtype=C.values.dtype, device=C.device)
    a, c = (1 - 0.85) / n, 0.85
    for _ in range(iters):
        s = a * r.sum()
        r = (c * r)[None, :] @ C.values
        r = r[0] + s
    r = r / r.sum()
    return r.cpu().numpy()
