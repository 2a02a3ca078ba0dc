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
``CsrMatrix`` raises.

:func:`dpagerank2` runs the reference's ``dpagerank2.c``: the PageRank
semiring over the user-defined struct type ``PAGERANK_TYPE`` = {rank,
invdegree} (:func:`pagerank_ops`), a ``vxm`` with a struct accum each
iteration on the bitmap ``Matrix`` (the generic path of
``semiring_mm``), and an ``eWiseAdd`` + ``reduce_to_scalar`` for the
change.  :func:`dpagerank2_csr` runs the same recurrence on a
``CsrMatrix`` through the user-defined edge-parallel SpMV
(``csr_mxv``'s struct path and the generic segmented fold) at O(nnz)
memory, with the accum rule and the change written out as the JAX
package's ``dpagerank2_csr`` writes them, so the two agree.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.matrix import Matrix, Vector
from ..core.monoids import monoid, monoid_new
from ..core.ops import BinaryOp, UnaryOp, binary
from ..core.semirings import semiring, semiring_new
from ..core.types import BOOL, FP64, UINT64, Type, cast
from ..ops.assign import assign_vector
from ..ops.containers import UnsupportedContainer
from ..ops.ewise import apply as gb_apply
from ..ops.ewise import eWiseAdd
from ..ops.mxm import vxm
from ..ops.reduce import reduce_to_scalar, reduce_to_vector

__all__ = ["drowscale", "irowscale", "dpagerank", "ipagerank",
           "dpagerank2", "dpagerank2_csr", "pagerank_jit", "PAGERANK_TYPE",
           "pagerank_ops"]

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


# ---------------------------------------------------------------------------
# dpagerank2: the PageRank semiring on a user-defined type {rank, invdegree}
# ---------------------------------------------------------------------------

PAGERANK_TYPE = Type.udt("pagerank_type", rank=FP64, invdegree=FP64)


def pagerank_ops():
    """The PageRank semiring's parts (mult, add, monoid, semiring) over
    ``PAGERANK_TYPE`` (``dpagerank2.c:83-101``): the multiply takes an
    edge to ``x.rank * x.invdegree``, the add sums ranks."""
    mult = BinaryOp("PAGERANK_MULT", lambda x, y: {
        "rank": torch.where(torch.as_tensor(y).to(torch.bool),
                            x["rank"] * x["invdegree"], 0.0),
        "invdegree": torch.zeros_like(x["invdegree"])},
        PAGERANK_TYPE, PAGERANK_TYPE, BOOL)
    add = BinaryOp("PAGERANK_ADD", lambda x, y: {
        "rank": x["rank"] + y["rank"],
        "invdegree": x["invdegree"] + y["invdegree"]},
        PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE)
    mon = monoid_new(add, {"rank": 0.0, "invdegree": 0.0})
    return mult, add, mon, semiring_new(mon, mult)


def _ranked(I: np.ndarray, X: np.ndarray) -> List[Tuple[int, float]]:
    order = np.argsort(-X, kind="stable")
    return [(int(I[k]), float(X[k])) for k in order]


def dpagerank2(A: Matrix, itermax: int = 100, tol: float = 1e-5
               ) -> Tuple[List[Tuple[int, float]], int]:
    """PageRank through a user-defined semiring over {rank, invdegree}
    (reference ``dpagerank2.c``, ``GrB_Type_new`` + ``GrB_Semiring_new``
    with struct types) on a bitmap ``Matrix``.  Returns ([(page,
    rank)...] by rank, iterations)."""
    A = _bitmap(A, "dpagerank2")
    n = A.nrows
    dev = A.device
    damping = 0.85
    teleport = (1 - damping) / n
    init_rank = 1.0 / n

    # r = init_page(dout): rank = 1/n, invdegree = 1/outdegree
    dout = reduce_to_vector(Vector.new(FP64, n, device=dev), None, None,
                            monoid.plus[FP64], A)
    init_page = UnaryOp("INIT_PAGE", lambda x: {
        "rank": torch.full_like(x, init_rank), "invdegree": 1.0 / x},
        PAGERANK_TYPE, FP64)
    r = gb_apply(Vector.new(PAGERANK_TYPE, n, device=dev), None, None,
                 init_page, dout)

    _, _, _, pr_semiring = pagerank_ops()
    # accum: rnew = damping * rank + teleport, invdegree kept from r
    pr_accum = BinaryOp("PAGERANK_ACCUM", lambda x, y: {
        "rank": damping * y["rank"] + teleport,
        "invdegree": x["invdegree"]},
        PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE)
    pr_diff = BinaryOp("PAGERANK_DIFF", lambda x, y: {
        "rank": (x["rank"] - y["rank"]) ** 2,
        "invdegree": torch.zeros_like(x["invdegree"])},
        PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE)
    rank_sum = monoid_new(
        BinaryOp("RANKSUM", lambda x, y: {
            "rank": x["rank"] + y["rank"], "invdegree": x["invdegree"]},
            PAGERANK_TYPE, PAGERANK_TYPE, PAGERANK_TYPE),
        {"rank": 0.0, "invdegree": 0.0})
    Abool = Matrix(A.pattern if A.type.is_bool else A.values != 0,
                   A.pattern, BOOL)

    tol2 = tol * tol
    rdiff = 1.0
    iters = 0
    while iters < itermax and rdiff > tol2:
        # rnew = accum(r, r +.* A)  (the safe variant, dpagerank2.c:332-350)
        rnew = vxm(r, None, pr_accum, pr_semiring, r, Abool)
        d = eWiseAdd(Vector.new(PAGERANK_TYPE, n, device=dev), None, None,
                     pr_diff, r, rnew)
        rdiff = float(reduce_to_scalar(None, rank_sum, d)["rank"])
        r = rnew
        iters += 1

    get_rank = UnaryOp("GET_RANK", lambda x: x["rank"], FP64, PAGERANK_TYPE)
    rd = gb_apply(Vector.new(FP64, n, device=dev), None, None, get_rank, r)
    s = float(reduce_to_scalar(None, monoid.plus[FP64], rd))
    I, X = rd.extractTuples()
    return _ranked(I, X / s), iters


def dpagerank2_csr(A, itermax: int = 100, tol: float = 1e-5
                   ) -> Tuple[List[Tuple[int, float]], int]:
    """:func:`dpagerank2` on a ``CsrMatrix``: the PageRank semiring
    through the user-defined SpMV (``csr_mxv``'s struct path with the
    generic segmented fold) at O(nnz) memory.  The accum rule (an absent
    rank takes the product verbatim) and the change (an eWiseAdd of
    ``pr_diff``) are written out as the JAX package's
    ``dpagerank2_csr`` writes them, so the two containers agree."""
    from ..sparse.container import CsrMatrix
    from ..sparse.spmv import csr_mxv
    if not isinstance(A, CsrMatrix):
        A = CsrMatrix.from_matrix(A)
    A = A.wait()
    n = A.nrows
    dev = A.device
    damping = 0.85
    teleport = (1 - damping) / n
    init_rank = 1.0 / n

    # dout = the plus-reduce of A's rows as FP64 (pattern: nonempty rows)
    live = torch.arange(A.nzmax, device=dev) < A.nvals
    av = torch.where(live, cast(A.values, FP64, A.type), 0.0)
    dout = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    dout.index_add_(0, A.rowids.long().clamp(max=n), av)
    dout = dout[:n]
    rp = A.row_degrees() > 0
    r = {"rank": torch.where(rp, torch.full_like(dout, init_rank), 0.0),
         "invdegree": torch.where(rp, 1.0 / dout, 0.0)}

    pr_mult, _, pr_monoid, _ = pagerank_ops()
    # csr_mxv computes mult(a_edge, x); the PageRank multiply is
    # mult(x, edge): flip it (GB_AxB_dot_flipxy.c)
    flip = BinaryOp("PAGERANK_MULT_FLIP", lambda a, x: pr_mult.fn(x, a),
                    PAGERANK_TYPE, BOOL, PAGERANK_TYPE)
    sr = semiring_new(pr_monoid, flip)
    # vxm: x'A = (A')x, on A' with bool values
    AT = A.T()
    ATb = CsrMatrix(AT.indptr, AT.indices, AT.rowids, AT.values != 0,
                    AT.nvals, AT.nrows, AT.ncols, BOOL)

    tol2 = tol * tol
    rdiff = 1.0
    iters = 0
    while iters < itermax and rdiff > tol2:
        y, tp = csr_mxv(sr, ATb, r, x_pattern=rp)
        only_t = tp & ~rp
        rank_new = torch.where(tp & rp, damping * y["rank"] + teleport,
                               torch.where(only_t, y["rank"], r["rank"]))
        inv_new = torch.where(only_t, y["invdegree"], r["invdegree"])
        new_pat = rp | tp
        # the eWiseAdd(pr_diff) change: the intersection gives (dr)^2,
        # an entry only in the new ranks its raw rank
        d = torch.where(rp & new_pat, (r["rank"] - rank_new) ** 2,
                        torch.where(new_pat, rank_new, 0.0))
        rdiff = float(d.sum())
        r, rp = {"rank": rank_new, "invdegree": inv_new}, new_pat
        iters += 1

    rpn = rp.cpu().numpy()
    ranks = r["rank"].cpu().numpy()
    s = float(ranks[rpn].sum())
    return _ranked(np.nonzero(rpn)[0], ranks[rpn] / s), iters


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
