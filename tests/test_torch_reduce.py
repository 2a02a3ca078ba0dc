"""PyTorch port, ``reduce_to_vector`` / ``reduce_to_scalar`` / ``reduce``:
a mirror of ``tests/test_reduce.py`` in parity with the JAX package, on
bitmap containers and, beyond the JAX test, on ``CsrMatrix`` and
``CscMatrix`` (against the JAX package's same containers).

The same numpy-seeded operands (``tests.helpers.rand_om``) go through
both packages.  Patterns, integers and booleans must be equal exactly;
a float reduction of n terms within n * 2^-24 * sum |x| (FP32) or
n * 2^-53 * sum |x| (FP64) of the JAX package's, per output.  The last
test holds the CSR row reduce's float MIN/MAX to the bitmap reduce's
answer where the JAX package's CSR reduce propagates NaN (ROADMAP.md
queue 3, "known in the reference")."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
import graphblas_tpu_torch as gt

from . import oracle as orc
from .helpers import TYPES, rand_om, to_gb
from .test_reduce import MONOIDS
from .test_torch_ewise_containers import both
from .test_torch_mxm import to_gt

EPS = {"FP32": 2.0 ** -24, "FP64": 2.0 ** -53}


def _bound(tname, vals, pat, axis):
    """n * eps * sum |x| over each reduced slice (n its term count)."""
    a = np.abs(np.where(pat, vals, 0).astype(np.float64))
    return pat.sum(axis=axis) * EPS[tname] * a.sum(axis=axis)


def _same_vector(got, want, tname, A, axis=1):
    wp = np.asarray(want.pattern)
    assert got.type.name == want.type.name
    assert np.array_equal(got.pattern_np(), wp)
    g, w = got.to_dense(), np.asarray(want.values)
    if tname in EPS:
        err = np.abs(g.astype(np.float64) - w.astype(np.float64))
        assert (err <= _bound(tname, A.m, A.p, axis)).all(), (g, w)
    else:
        assert np.array_equal(g, w)


def _same_scalar(got, want, tname, A):
    assert np.asarray(got).dtype == np.asarray(want).dtype
    if tname in EPS:
        assert abs(float(got) - float(want)) <= \
            _bound(tname, A.m.ravel(), A.p.ravel(), 0)
    else:
        assert got == want, (got, want)


@pytest.mark.parametrize("mon,tname", MONOIDS)
def test_reduce_to_vector(rng, mon, tname):
    t = TYPES[tname]
    A = rand_om(rng, (5, 7), t.dtype, 0.5)
    want = gb.reduce_to_vector(gb.Vector.new(t, 5), None, None,
                               gb.monoid[mon][t], to_gb(A, t))
    tt = getattr(gt, tname)
    got = gt.reduce_to_vector(gt.Vector.new(tt, 5, device="cpu"), None,
                              None, gt.monoid[mon][tt], to_gt(A, tname))
    _same_vector(got, want, tname, A)


@pytest.mark.parametrize("mon,tname", MONOIDS)
def test_reduce_to_scalar(rng, mon, tname):
    t = TYPES[tname]
    A = rand_om(rng, (4, 6), t.dtype, 0.5)
    want = gb.reduce_to_scalar(None, gb.monoid[mon][t], to_gb(A, t))
    tt = getattr(gt, tname)
    got = gt.reduce_to_scalar(None, gt.monoid[mon][tt], to_gt(A, tname))
    _same_scalar(got, want, tname, A)


@pytest.mark.parametrize("kind", ["csr", "csc"])
@pytest.mark.parametrize("mon,tname", MONOIDS)
def test_reduce_sparse_containers(rng, kind, mon, tname):
    """Row and column reduces and the scalar on CSR / CSC, against the
    JAX package's same containers (its CSR row reduce with no NaN in
    the input: these are finite)."""
    t = TYPES[tname]
    tt = getattr(gt, tname)
    A = rand_om(rng, (6, 5), t.dtype, 0.5)
    At, Aj = both(kind, A, tname)
    for tran, n in ((False, 6), (True, 5)):
        d = gb.TRAN0 if tran else None
        want = gb.reduce_to_vector(gb.Vector.new(t, n), None, None,
                                   gb.monoid[mon][t], Aj, d)
        got = gt.reduce_to_vector(gt.Vector.new(tt, n, device="cpu"), None,
                                  None, gt.monoid[mon][tt], At,
                                  gt.TRAN0 if tran else None)
        _same_vector(got, want, tname, A, axis=0 if tran else 1)
    want = gb.reduce_to_scalar(None, gb.monoid[mon][t], Aj)
    got = gt.reduce_to_scalar(None, gt.monoid[mon][tt], At)
    _same_scalar(got, want, tname, A)


def test_reduce_empty_gives_identity():
    for C in (gt.Matrix.new(gt.FP64, 3, 3, device="cpu"),
              gt.CsrMatrix.from_coo([], [], np.zeros(0), 3, 3,
                                    type=gt.FP64, device="cpu")):
        assert gt.reduce_to_scalar(None, gt.monoid.plus[gt.FP64], C) == 0.0
        assert gt.reduce_to_scalar(None, gt.monoid.min[gt.FP64], C) == \
            gb.reduce_to_scalar(None, gb.monoid.min[gb.FP64],
                                gb.Matrix.new(gb.FP64, 3, 3)) == np.inf
    assert gt.reduce_to_scalar(None, gt.monoid.lor[gt.BOOL],
                               gt.Matrix.new(gt.BOOL, 2, 2, device="cpu")) \
        == False  # noqa: E712


def test_reduce_cols_desc_tran(rng):
    A = rand_om(rng, (5, 7), np.float64, 0.5)
    want = gb.reduce_to_vector(gb.Vector.new(gb.FP64, 7), None, None,
                               gb.monoid.plus[gb.FP64], to_gb(A, gb.FP64),
                               gb.TRAN0)
    got = gt.reduce_to_vector(gt.Vector.new(gt.FP64, 7, device="cpu"), None,
                              None, gt.monoid.plus[gt.FP64],
                              to_gt(A, "FP64"), gt.TRAN0)
    _same_vector(got, want, "FP64", A, axis=0)


def test_reduce_with_accum_scalar(rng):
    A = rand_om(rng, (3, 3), np.int64, 0.9)
    for Xt in (to_gt(A, "INT64"), both("csr", A, "INT64")[0]):
        got = gt.reduce_to_scalar(gt.binary.plus[gt.INT64],
                                  gt.monoid.plus[gt.INT64], Xt, c=100)
        assert got == orc.o_reduce_scalar("plus", np.int64, A) + 100
        assert got == gb.reduce_to_scalar(gb.binary.plus[gb.INT64],
                                          gb.monoid.plus[gb.INT64],
                                          to_gb(A, gb.INT64), c=100)


def test_reduce_vector_mask(rng):
    A = rand_om(rng, (5, 4), np.float64, 0.6)
    w = rand_om(rng, (5,), np.float64, 0.5)
    m = rand_om(rng, (5,), np.bool_, 0.6)
    want = gb.reduce_to_vector(to_gb(w, gb.FP64), to_gb(m, gb.BOOL), None,
                               gb.monoid.max[gb.FP64], to_gb(A, gb.FP64),
                               gb.SCMP)
    for Xt in (to_gt(A, "FP64"), both("csr", A, "FP64")[0]):
        got = gt.reduce_to_vector(to_gt(w, "FP64"), to_gt(m, "BOOL"), None,
                                  gt.monoid.max[gt.FP64], Xt, gt.SCMP)
        _same_vector(got, want, "FP64", A)


def test_reduce_dispatch_and_binary_op(rng):
    """``reduce`` dispatches on its output; a bare binary op finds its
    built-in monoid."""
    A = rand_om(rng, (4, 5), np.int32, 0.6)
    At = to_gt(A, "INT32")
    w = gt.reduce(gt.Vector.new(gt.INT32, 4, device="cpu"), None, None,
                  gt.binary.plus[gt.INT32], At)
    assert np.array_equal(w.to_dense(), np.where(A.p, A.m, 0).sum(1))
    s = gt.reduce(None, "max", At)
    assert s == gb.reduce(None, "max", to_gb(A, gb.INT32))


def test_uint64_sum_is_unsigned():
    """A UINT64 sum crosses to the host as an unsigned numpy scalar."""
    big = np.uint64(3) << np.uint64(62)          # 3 * 2^62 > int64 max
    X = np.array([big // np.uint64(3)] * 3, np.uint64)
    I, J = np.array([0, 1, 2]), np.array([2, 0, 1])
    for At in (gt.CsrMatrix.from_coo(I, J, X, 3, 3, type=gt.UINT64,
                                     device="cpu"),
               gt.Matrix.from_coo(I, J, X, 3, 3, type=gt.UINT64,
                                  device="cpu")):
        got = gt.reduce_to_scalar(None, gt.monoid.plus[gt.UINT64], At)
        assert isinstance(got, np.uint64) and got == big
    Aj = JCsr.from_coo(I, J, X, 3, 3, type=gb.UINT64)
    assert gb.reduce_to_scalar(None, gb.monoid.plus[gb.UINT64], Aj) == big


@pytest.mark.parametrize("mon", ["min", "max"])
@pytest.mark.parametrize("kind", ["csr", "csc"])
def test_csr_reduce_rows_nan_min_max_follows_bitmap(kind, mon):
    """A = [[nan, 2], [absent, 1]] FP32: every port container gives the
    JAX bitmap reduce's answer, NaN ignored ([2, 1] for both MIN and
    MAX); the JAX package's CSR row reduce gives [nan, 1]."""
    nan = np.float32(np.nan)
    I, J = np.array([0, 0, 1]), np.array([0, 1, 1])
    X = np.array([nan, 2.0, 1.0], np.float32)
    want = np.array([2.0, 1.0], np.float32)
    Aj_bitmap = gb.Matrix.from_coo(I, J, X, 2, 2, type=gb.FP32)
    Aj_csr = JCsr.from_coo(I, J, X, 2, 2, type=gb.FP32,
                           sum_duplicates=False)
    monj = gb.monoid[mon][gb.FP32]
    jb = gb.reduce_to_vector(gb.Vector.new(gb.FP32, 2), None, None, monj,
                             Aj_bitmap)
    jc = gb.reduce_to_vector(gb.Vector.new(gb.FP32, 2), None, None, monj,
                             Aj_csr)
    assert np.array_equal(np.asarray(jb.values), want)
    ref = np.asarray(jc.values)
    assert np.isnan(ref[0]) and ref[1] == 1.0      # the reference's NaN
    o = orc.OM(np.array([[nan, 2.0], [0.0, 1.0]], np.float32),
               np.array([[True, True], [False, True]]))
    mont = gt.monoid[mon][gt.FP32]
    for At in (both(kind, o, "FP32")[0], to_gt(o, "FP32")):
        got = gt.reduce_to_vector(gt.Vector.new(gt.FP32, 2, device="cpu"),
                                  None, None, mont, At)
        assert np.array_equal(got.to_dense(), want)
        assert got.pattern_np().all()
    # a full row of NaN reduces to NaN on the bitmap, and so on CSR
    full = orc.OM(np.array([[nan, nan], [nan, 3.0]], np.float32),
                  np.ones((2, 2), bool))
    bm = gt.reduce_to_vector(gt.Vector.new(gt.FP32, 2, device="cpu"), None,
                             None, mont, to_gt(full, "FP32")).to_dense()
    sp = gt.reduce_to_vector(gt.Vector.new(gt.FP32, 2, device="cpu"), None,
                             None, mont, both(kind, full, "FP32")[0])
    assert np.isnan(bm[0]) and bm[1] == 3.0
    assert np.array_equal(sp.to_dense(), bm, equal_nan=True)
