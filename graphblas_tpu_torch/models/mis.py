"""Luby's maximal independent set (reference ``Demo/Source/mis.c``,
``mis_check.c``, ``mis_score.c``).

Counterpart of ``graphblas_tpu/models/mis.py``.  Iteration: score
candidates with a degree-weighted random probability, select nodes
whose score beats every neighbor's (max-select1st semiring), add them to
the set, then drop them and their neighbors from the candidate pool.
Singletons join the set up front.

The random scores use the reference's portable simple_rand stream
(``mis_score.c``: 0.0001 + x/(1+2*degree)) in the JAX package's order:
one draw for every entry of ``degrees`` on every pass, candidate or not,
so the stream and the set match it bit for bit.  Every pass runs on A's
device: the draws by :meth:`SimpleRand.rand_x_tensor` (the stream's
jump-ahead, state advanced on the host), each entry's draw found by its
rank among the entries of ``degrees``, then ``prob<candidates> =
mis_score(degrees)`` as ``mis.c`` writes it, a ``GrB_apply`` under the
candidates mask (span ``gb.engines.mis_score``).  The only reads are
the candidates' ``nvals``, twice a pass, and once a call with the
number of ``degrees``' entries (``gb.read.mis_nvals``); whether
``prob`` and ``new_members`` hold every entry, which ``vxm`` asks to
choose its engine, follows from the same count.  The counts
``mis.passes`` and ``mis.draws`` add up the passes and the draws.  A
takes any matrix container on any device (a ``CsrMatrix`` is turned
once into its by-column twin, as in :mod:`.bfs`); the call is the span
``gb.entry.mis``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.descriptor import Descriptor
from ..core.matrix import Vector
from ..core.monoids import monoid, monoid_new
from ..core.ops import UnaryOp, binary
from ..core.semirings import semiring, semiring_new
from ..core.types import BOOL, FP64
from ..ops.assign import assign_vector
from ..ops.ewise import apply as gb_apply, eWiseAdd
from ..ops.mxm import vxm
from ..ops.reduce import reduce_to_vector
from ..utils import counters
from ..utils.counters import host_read
from ..utils.simple_rand import SimpleRand
from .bfs import vxm_operand

__all__ = ["mis", "mis_check"]

_R_DESC = Descriptor(replace=True)
_SR_DESC = Descriptor(replace=True, mask_scmp=True)
_ID = UnaryOp("ID", lambda x: x, BOOL, BOOL)


def _nvals(v: Vector) -> int:
    return host_read(v.wait().pattern.sum(), "mis_nvals")


@counters.spanned("gb.entry.mis")
def mis(A, seed: int = 1, rng: Optional[SimpleRand] = None) -> Vector:
    """iset[i] = True if node i is in the maximal independent set.

    A must be symmetric boolean-structural; scores follow mis_score.c.
    """
    A = A.wait()
    n = A.nrows
    dev = A.device
    rng = rng or SimpleRand(seed)
    Aop = vxm_operand(A)

    max_select1st = semiring_new(
        monoid_new(binary.max[FP64], 0.0), binary.first[FP64])
    boolean = semiring.lor_land[BOOL]

    # degrees = reduce rows of A (as fp64)
    degrees = reduce_to_vector(Vector.new(FP64, n, device=dev), None, None,
                               monoid.plus[FP64], A)
    # candidates<degrees> = true ; singletons (degree 0 / absent) -> iset
    candidates = assign_vector(Vector.new(BOOL, n, device=dev), degrees,
                               None, True, None, None, scalar=True)
    iset = assign_vector(Vector.new(BOOL, n, device=dev), degrees, None,
                         True, None, _SR_DESC, scalar=True)
    # one read: the draws a pass (the entries of degrees) and the
    # candidates; each entry's draw is its rank among the entries
    ndeg, nvals = (int(x) for x in host_read(
        torch.stack([degrees.pattern.sum(), candidates.pattern.sum()]),
        "mis_nvals", np.ndarray))
    rank = (torch.cumsum(degrees.pattern, 0) - 1).clamp(min=0)

    last_nvals = nvals
    while nvals > 0:
        counters.count("mis.passes")
        counters.count("mis.draws", ndeg)
        full = nvals == n
        with counters.span("gb.engines.mis_score"):
            # prob<candidates> = mis_score(degrees): the draws for EVERY
            # entry of degrees (GrB_apply computes op(degrees) first and
            # masks afterwards, mis.c:109-110)
            x = rng.rand_x_tensor(ndeg, dev)[rank]
            score = UnaryOp("MIS_SCORE",
                            lambda d: 0.0001 + x / (1.0 + 2.0 * d),
                            FP64, FP64)
            prob = gb_apply(Vector.new(FP64, n, device=dev), candidates,
                            None, score, degrees).learn_full(full)

        # neighbor_max<candidates> = prob max.select1st A
        neighbor_max = vxm(Vector.new(FP64, n, device=dev), candidates,
                           None, max_select1st, prob, Aop, _R_DESC)
        # new_members = prob > neighbor_max  (eWiseAdd GT); its pattern
        # is the candidates'
        new_members = eWiseAdd(Vector.new(BOOL, n, device=dev), None, None,
                               binary.gt[FP64], prob, neighbor_max
                               ).learn_full(full)
        # iset |= new_members
        iset = eWiseAdd(iset, None, None, binary.lor[BOOL], iset,
                        new_members)
        # candidates<!new_members> = candidates (REPLACE): drop new members
        candidates = gb_apply(candidates, new_members, None, _ID,
                              candidates, _SR_DESC)
        nvals = _nvals(candidates)
        if nvals == 0:
            break
        # new_neighbors<candidates> = new_members lor.land A
        new_neighbors = vxm(Vector.new(BOOL, n, device=dev), candidates,
                            None, boolean, new_members, Aop)
        candidates = gb_apply(candidates, new_neighbors, None, _ID,
                              candidates, _SR_DESC)
        nvals = _nvals(candidates)
        if nvals == last_nvals:
            raise RuntimeError("mis stalled (corrupted input?)")
        last_nvals = nvals

    # drop explicit false values: iset<iset> = iset (REPLACE)
    return gb_apply(iset, iset, None, _ID, iset, _R_DESC)


def mis_check(A, iset: Vector) -> bool:
    """Verify independence + maximality (the demo's verification pass)
    on the host, with sparse products.

    Adjacency is VALUED, matching the algorithm's LAND semiring:
    explicit false entries (files with 0-valued triplets, e.g.
    fs_183_1) are not edges."""
    I, J, X = A.wait().extractTuples()
    edge = np.asarray(X) != 0
    I, J = I[edge], J[edge]
    s = np.zeros(A.nrows, bool)
    Is, Xs = iset.extractTuples()
    s[Is[np.asarray(Xs, bool)]] = True
    # independent: no edge inside the set
    if np.any(s[I] & s[J]):
        return False
    # maximal: every non-member has a neighbor in the set (or no edge at all)
    deg = np.bincount(I, minlength=A.nrows)
    covered = (np.bincount(I[s[J]], minlength=A.nrows) > 0) | (deg == 0)
    return bool(np.all(covered[~s]))
