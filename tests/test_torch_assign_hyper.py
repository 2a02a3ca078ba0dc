"""PyTorch port, assign / subassign / extract on ``HyperMatrix`` (pair
keys, dimensions past 2^40) and the ``CscMatrix`` frame: parity with the
JAX package.

Mirrors ``tests/test_assign_hyper.py``: the same numpy-seeded spec
matrices go through the JAX package's operation and the port's; the
outputs must be equal exactly (the region split, the epilogue and the
re-sort reassociate nothing), and each is held to the numpy spec
(``tests/oracle.py``, ``GB_spec_assign.m`` / ``GB_spec_subassign.m``) as
the JAX test holds the JAX package.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.sparse.container import CscMatrix as JCsc
from graphblas_tpu.sparse.hyper import HyperMatrix as JHyper
import graphblas_tpu_torch as gt

from . import oracle as orc
from .helpers import rand_om
from .test_assign_hyper import o_assign, o_subassign, to_om

CPU = "cpu"


def om_both(kind, o, tname):
    """(port, JAX) container of one kind for the spec matrix ``o``."""
    I, J = np.nonzero(o.p)
    X = o.m[I, J]
    m, n = o.p.shape
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    if kind == "csc":
        return (gt.CscMatrix.from_coo(I, J, X, m, n, type=tt,
                                      sum_duplicates=False, device=CPU),
                JCsc.from_coo(I, J, X, m, n, type=tj, sum_duplicates=False))
    return (gt.HyperMatrix.from_coo(I, J, X, m, n, type=tt, dup=None,
                                    device=CPU),
            JHyper.from_coo(I, J, X, m, n, type=tj, dup=None))


def same(Xt, Xj):
    assert type(Xt).__name__ == type(Xj).__name__
    for x, y in zip(Xt.extractTuples(), Xj.extractTuples()):
        assert np.array_equal(x, np.asarray(y))


def _pick(pair, k):
    return None if pair is None else pair[k]


@pytest.mark.parametrize("kind", ["hyper", "csc"])
def test_subassign_sweep(kind):
    rng = np.random.default_rng(201)
    Ii = np.array([5, 1, 3])
    Jj = np.array([0, 4, 2, 6])
    for accum_name in (None, "plus"):
        for has_mask in (False, True):
            for replace in (False, True):
                for scmp in (False, True):
                    C = rand_om(rng, (7, 8), np.float64, 0.5)
                    A = rand_om(rng, (3, 4), np.float64, 0.6)
                    M = rand_om(rng, (3, 4), np.bool_, 0.5) \
                        if has_mask else None
                    want = o_subassign(C, M, A, Ii, Jj, accum_name,
                                       np.float64, replace, scmp)
                    Cs, As = om_both(kind, C, "FP64"), om_both(kind, A,
                                                               "FP64")
                    Ms = om_both(kind, M, "BOOL") if M else None
                    got = []
                    for k, pkg in enumerate((gt, gb)):
                        got.append(pkg.subassign(
                            Cs[k], _pick(Ms, k),
                            pkg.binary.plus[pkg.FP64] if accum_name
                            else None, As[k], Ii, Jj,
                            pkg.Descriptor(replace=replace,
                                           mask_scmp=scmp)))
                    same(*got)
                    g = to_om(got[0], (7, 8), np.float64)
                    tag = (f"{kind} accum={accum_name} mask={has_mask} "
                           f"replace={replace} scmp={scmp}")
                    assert np.array_equal(g.p, want.p), tag
                    assert np.allclose(g.m, want.m), tag


@pytest.mark.parametrize("kind", ["hyper", "csc"])
def test_assign_sweep(kind):
    rng = np.random.default_rng(202)
    Ii = np.array([2, 6])
    Jj = np.array([1, 3, 5])
    for accum_name in (None, "plus"):
        for has_mask in (False, True):
            for replace in (False, True):
                C = rand_om(rng, (7, 8), np.float64, 0.5)
                A = rand_om(rng, (2, 3), np.float64, 0.7)
                M = rand_om(rng, (7, 8), np.bool_, 0.5) \
                    if has_mask else None
                want = o_assign(C, M, A, Ii, Jj, accum_name, np.float64,
                                replace, False)
                Cs, As = om_both(kind, C, "FP64"), om_both(kind, A, "FP64")
                Ms = om_both(kind, M, "BOOL") if M else None
                got = [pkg.assign(Cs[k], _pick(Ms, k),
                                  pkg.binary.plus[pkg.FP64] if accum_name
                                  else None, As[k], Ii, Jj,
                                  pkg.Descriptor(replace=replace))
                       for k, pkg in enumerate((gt, gb))]
                same(*got)
                g = to_om(got[0], (7, 8), np.float64)
                assert np.array_equal(g.p, want.p)
                assert np.allclose(g.m, want.m)


@pytest.mark.parametrize("kind", ["hyper", "csc"])
def test_extract_container(kind):
    rng = np.random.default_rng(203)
    A = rand_om(rng, (8, 9), np.float64, 0.5)
    Ii = np.array([7, 0, 3])
    Jj = np.array([2, 8, 5, 1])
    C = rand_om(rng, (3, 4), np.float64, 0.4)
    T = orc.OM(A.m[np.ix_(Ii, Jj)], A.p[np.ix_(Ii, Jj)])
    want = orc.o_accum_mask(C, None, T, "plus", np.float64, np.float64)
    Cs, As = om_both(kind, C, "FP64"), om_both(kind, A, "FP64")
    got = [pkg.extract(Cs[k], None, pkg.binary.plus[pkg.FP64], As[k], Ii,
                       Jj) for k, pkg in enumerate((gt, gb))]
    same(*got)
    g = to_om(got[0], (3, 4), np.float64)
    assert np.array_equal(g.p, want.p) and np.allclose(g.m, want.m)


def test_scalar_assign_hyper():
    rng = np.random.default_rng(204)
    C = rand_om(rng, (6, 6), np.float64, 0.4)
    Ii = np.array([1, 4])
    Jj = np.array([0, 5])
    want = C.copy()
    want.m[np.ix_(Ii, Jj)] = 3.5
    want.p[np.ix_(Ii, Jj)] = True
    Cs = om_both("hyper", C, "FP64")
    got = [pkg.subassign(Cs[k], None, None, 3.5, Ii, Jj, scalar=True)
           for k, pkg in enumerate((gt, gb))]
    same(*got)
    g = to_om(got[0], (6, 6), np.float64)
    assert np.array_equal(g.p, want.p) and np.allclose(g.m, want.m)
    got = [pkg.assign(Cs[k], None, pkg.binary.plus[pkg.FP64], 1.0, Ii, Jj,
                      scalar=True) for k, pkg in enumerate((gt, gb))]
    same(*got)


def test_hyper_assign_2p45():
    """subassign / assign / extract on indices far beyond 2^40 (no
    linearized key survives this)."""
    dim = 1 << 45
    base = np.int64(31) << 33
    CI = base + np.array([0, 5, 9], np.int64)
    CJ = base + np.array([2, 7, 4], np.int64)
    CX = np.array([1.0, 2.0, 3.0])
    Ii = np.array([base + 5, dim - 2], np.int64)       # rows
    Jj = np.array([base + 7, base + 100], np.int64)    # cols
    ops = []
    for pkg in (gt, gb):
        kw = {"device": CPU} if pkg is gt else {}
        H = pkg.HyperMatrix if pkg is gt else JHyper
        C = H.from_coo(CI, CJ, CX, dim, dim, type=pkg.FP64, **kw)
        A = H.from_coo(np.array([0, 1], np.int64), np.array([0, 1], np.int64),
                       np.array([50.0, 60.0]), 2, 2, type=pkg.FP64, **kw)
        E = H.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0), 2, 2, type=pkg.FP64, **kw)
        sub = pkg.subassign(C, None, None, A, Ii, Jj)
        ops.append([sub, pkg.extract(E, None, None, sub, Ii, Jj),
                    pkg.assign(C, None, None, A, Ii, Jj),
                    pkg.assign(C, None, None, C)])
    for x, y in zip(*ops):
        same(x, y)
    sub, ext, asg, whole = ops[0]
    d = {(int(i), int(j)): float(x) for i, j, x in zip(*sub.extractTuples())}
    assert d == {(int(base), int(base + 2)): 1.0,
                 (int(base + 9), int(base + 4)): 3.0,
                 (int(base + 5), int(base + 7)): 50.0,
                 (int(dim - 2), int(base + 100)): 60.0}
    assert {(int(i), int(j)): float(x) for i, j, x in
            zip(*ext.extractTuples())} == {(0, 0): 50.0, (1, 1): 60.0}
    assert asg.extractElement(int(base + 5), int(base + 7)) == 50.0
    assert {(int(i), int(j)) for i, j, _ in zip(*whole.extractTuples())} \
        == set(zip(CI.tolist(), CJ.tolist()))


def test_hyper_assign_duplicate_indices_rejected():
    dim = 1 << 45
    C = gt.HyperMatrix.from_coo(np.array([1], np.int64),
                                np.array([1], np.int64), np.array([1.0]),
                                dim, dim, type=gt.FP64, device=CPU)
    A = gt.HyperMatrix.from_coo(np.array([0, 1], np.int64),
                                np.array([0, 0], np.int64),
                                np.array([1.0, 2.0]), 2, 1, type=gt.FP64,
                                device=CPU)
    with pytest.raises(gt.InvalidValue):
        gt.subassign(C, None, None, A, np.array([3, 3]), np.array([5]))
