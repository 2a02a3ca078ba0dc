"""PyTorch port, the SpMV slice: parity with the JAX package.

The same numpy-seeded inputs go through the JAX package's ``csr_mxv`` /
``csr_vxm`` / ``mxv`` / ``vxm`` and the port's, on the CPU.  Patterns,
integers and booleans must be equal; floats agree within rtol=1e-5,
atol=1e-6 (the segment sums reassociate the row sums).  Mirrors ``test_sparse.py`` (SpMV part),
``test_csc.py``, ``test_mxm.py::test_mxv_vxm`` and
``test_api.py::test_vxm_csr_noncommutative_flip``.

The JAX package's sort-routed dense-x engine is not ported; the port's
dense-x engine must give its output (integers and booleans exactly).
The JAX package's ``mxv`` always runs the sparse-x engine; the port's
``mxv`` with every entry of u present runs the dense-x engines, which
must give the same answer for non-finite and wide-ranged u as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core.descriptor import Descriptor as JDescriptor
from graphblas_tpu.sparse.container import CscMatrix as JCsc
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert

RTOL, ATOL = 1e-5, 1e-6


def _both_csr(I, J, X, m, n, tname, **kw):
    Aj = jsp.CsrMatrix.from_coo(I, J, X, m, n, type=getattr(gb, tname), **kw)
    return Aj, convert.from_jax(Aj, device="cpu")


def _rand_both(m, n, density, seed, tname="FP64"):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    vals = rng.normal(size=(m, n)) * mask
    I, J = np.nonzero(mask)
    X = vals[I, J]
    if tname != "FP64":
        X = X.astype(getattr(gb, tname).dtype)
    return _both_csr(I, J, X, m, n, tname), vals, mask


def _srs(name, tname):
    return gb.semiring[name][getattr(gb, tname)], \
        gt.semiring[name][getattr(gt, tname)]


def _same(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _same_yp(yt, pt, yj, pj, exact):
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    _same(yt.numpy().view(np.asarray(yj).dtype) if yt.dtype != torch.bool
          else yt.numpy(), np.asarray(yj), exact)


def _same_vec(wt, wj, exact):
    assert np.array_equal(wt.pattern_np(), wj.pattern_np())
    _same(wt.to_dense(), wj.to_dense(), exact)


@pytest.mark.parametrize("srname,tname", [
    ("plus_times", "FP64"), ("min_plus", "FP64"), ("max_times", "FP64"),
    ("plus_times", "INT32"), ("plus_times", "UINT32"), ("min_plus", "INT64"),
    ("times_plus", "INT16"), ("lxor_ne", "INT32"), ("eq_lt", "FP32"),
    ("max_div", "INT8"), ("plus_pair", "UINT8"), ("min_first", "FP32"),
])
def test_csr_mxv_semirings_match_jax(srname, tname):
    """Dense x through the port's dense-x engine and the JAX package's
    gather engine (``test_sparse.py:59``)."""
    rng = np.random.default_rng(4)
    (Aj, At), dense, mask = _rand_both(20, 16, 0.3, 3, "FP64")
    if tname != "FP64":
        I, J = np.nonzero(mask)
        X = (dense[I, J] * 10).astype(getattr(gb, tname).dtype)
        Aj, At = _both_csr(I, J, X, 20, 16, tname)
    srj, srt = _srs(srname, tname)
    t = getattr(gb, tname)
    x = (rng.normal(size=16) * 4).astype(t.dtype)
    yj, pj = jsp.csr_mxv(srj, Aj, jnp.asarray(x))
    yt, pt = gt.csr_mxv(srt, At, x)
    assert gt.last_axb_method() == "spmv:dense_x"
    _same_yp(yt, pt, yj, pj, exact=not t.dtype.kind == "f")
    # and the bitmap oracle of the JAX package
    u = gb.Vector.from_dense(x, t)
    want = gb.mxv(gb.Vector.new(srj.ztype, 20), None, None, srj,
                  Aj.to_matrix(), u)
    assert np.array_equal(pt.numpy(), want.pattern_np())


def test_csr_vxm_bool_matches_jax():
    """Sparse x: one-vertex frontier over lor_land (``test_sparse.py:80``)."""
    _, _, mask = _rand_both(12, 12, 0.3, 5)
    sym = mask | mask.T
    I, J = np.nonzero(sym)
    Aj, At = _both_csr(I, J, np.ones(len(I), bool), 12, 12, "BOOL")
    q = np.zeros(12, bool)
    q[2] = True
    srj, srt = _srs("lor_land", "BOOL")
    yj, pj = jsp.csr_vxm(srj, jnp.asarray(q), Aj.T(), x_pattern=q)
    yt, pt = gt.csr_vxm(srt, q, At.T(), x_pattern=q)
    assert gt.last_axb_method() == "spmv:sparse_x"
    _same_yp(yt, pt, yj, pj, exact=True)
    assert np.array_equal(yt.numpy() & pt.numpy(), sym[2])


@pytest.mark.parametrize("srname,tname", [
    ("min_plus", "FP64"), ("max_first", "INT32"), ("plus_times", "FP32"),
    ("lor_land", "BOOL"), ("times_second", "INT64"), ("lxor_eq", "UINT16"),
])
def test_csr_mxv_sparse_x_matches_jax(srname, tname):
    """Sparse x where mult(a, 0) is not the add identity: absent lanes
    must take the identity (``test_sparse.py:271``)."""
    t = getattr(gb, tname)
    (Aj, At), dense, mask = _rand_both(10, 8, 0.5, 40)
    if tname != "FP64":
        I, J = np.nonzero(mask)
        X = (dense[I, J] * 7).astype(t.dtype)
        Aj, At = _both_csr(I, J, X, 10, 8, tname)
    xp = np.zeros(8, bool)
    xp[[1, 4, 6]] = True
    x = np.where(xp, np.arange(8), 0).astype(t.dtype)
    srj, srt = _srs(srname, tname)
    yj, pj = jsp.csr_mxv(srj, Aj, jnp.asarray(x), x_pattern=xp)
    yt, pt = gt.csr_mxv(srt, At, x, x_pattern=xp)
    _same_yp(yt, pt, yj, pj, exact=t.dtype.kind != "f")
    u = gb.Vector.from_dense(x, t, pattern=xp)
    want = gb.mxv(gb.Vector.new(srj.ztype, 10), None, None, srj,
                  Aj.to_matrix(), u)
    assert np.array_equal(pt.numpy(), want.pattern_np())


def test_top_level_mxv_routes_csr():
    """``test_sparse.py:289``: mxv and vxm with TRAN1 on CSR."""
    (Aj, At), Ad, _ = _rand_both(9, 9, 0.4, 41)
    x = np.arange(9, dtype=np.float64)
    ut = gt.Vector.from_dense(x, device="cpu")
    sr = gt.semiring.plus_times[gt.FP64]
    w = gt.mxv(gt.Vector.new(gt.FP64, 9, device="cpu"), None, None, sr, At,
               ut)
    assert gt.last_axb_method() == "spmv:dense_x"
    np.testing.assert_allclose(w.to_dense(), Ad @ x, rtol=1e-12)
    w2 = gt.vxm(gt.Vector.new(gt.FP64, 9, device="cpu"), None, None, sr, ut,
                At, gt.TRAN1)
    np.testing.assert_allclose(w2.to_dense(), Ad @ x, rtol=1e-12)
    wj = gb.mxv(gb.Vector.new(gb.FP64, 9), None, None,
                gb.semiring.plus_times[gb.FP64], Aj,
                gb.Vector.from_dense(x))
    _same_vec(w, wj, exact=False)


@pytest.mark.parametrize("seed", [50, 52])
def test_bfs_csr_matches_jax(seed):
    """``test_sparse.py:306``: levels equal, exactly."""
    rng = np.random.default_rng(seed)
    pat = rng.random((80, 80)) < 0.05
    pat = (pat | pat.T) & ~np.eye(80, dtype=bool)
    I, J = np.nonzero(pat)
    Aj, At = _both_csr(I, J, np.ones(len(I), np.float32), 80, 80, "FP32")
    for s in (0, 7):
        want = jsp.bfs_csr(Aj, s)
        got = gt.bfs_csr(At, s)
        assert got.dtype == np.int32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("iters", [1, 20])
def test_pagerank_csr_matches_jax(iters):
    """``test_sparse.py:320``: float32 power iteration, within 1e-6
    relative (reassociated scatter sums)."""
    rng = np.random.default_rng(51)
    pat = rng.random((60, 60)) < 0.1
    np.fill_diagonal(pat, False)
    I, J = np.nonzero(pat)
    Aj, At = _both_csr(I, J, np.ones(len(I), np.float32), 60, 60, "FP32")
    want = jsp.pagerank_csr(Aj, iters=iters)
    got = gt.pagerank_csr(At, iters=iters)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_pagerank_csr_dangling_matches_jax():
    """Vertices with no out-edges (empty rows) and no in-edges: their
    mass drops, in both packages, within 1e-5 relative."""
    rng = np.random.default_rng(53)
    pat = rng.random((50, 50)) < 0.1
    np.fill_diagonal(pat, False)
    pat[:8] = False
    pat[:, 40:] = False
    I, J = np.nonzero(pat)
    Aj, At = _both_csr(I, J, np.ones(len(I), np.float32), 50, 50, "FP32")
    want = jsp.pagerank_csr(Aj, iters=20)
    got = gt.pagerank_csr(At, iters=20)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["inf", "nan", "wide"])
def test_mxv_nonfinite_and_wide_u_matches_jax(case):
    """u with an inf, with a NaN, or with 1e20 beside 1: ``gt.mxv``
    (dense-x engines, the tile engine forced on) equals the JAX
    package's ``gb.mxv`` (sparse-x engine), NaN where it has NaN and
    within rtol=1e-5 elsewhere.  A non-finite u never takes the tile
    engine; rows that do not read the bad entry stay finite."""
    rng = np.random.default_rng(30)
    half = 2500
    I = np.concatenate([rng.integers(0, 100, half),
                        rng.integers(100, 200, half)])
    J = np.concatenate([rng.integers(0, 100, half),
                        rng.integers(100, 200, half)])
    X = rng.uniform(0.5, 1.5, 2 * half).astype(np.float32)
    Aj, At = _both_csr(I, J, X, 200, 200, "FP32")
    x = rng.uniform(0.5, 1.5, 200).astype(np.float32)
    if case == "wide":
        x[:100] *= np.float32(1e20)
    else:
        x[5] = np.inf if case == "inf" else np.nan
    srt = gt.semiring.plus_times[gt.FP32]
    for force in (None, True):
        At._options["bsr_spmv"] = force
        got = gt.mxv(gt.Vector.new(gt.FP32, 200, device="cpu"), None, None,
                     srt, At, gt.Vector.from_dense(x, device="cpu"))
        assert gt.last_axb_method() == (
            "torch:bsr_spmv" if force and case == "wide" else "spmv:dense_x")
        want = gb.mxv(gb.Vector.new(gb.FP32, 200), None, None,
                      gb.semiring.plus_times[gb.FP32], Aj,
                      gb.Vector.from_dense(x))
        assert np.array_equal(got.pattern_np(), want.pattern_np())
        np.testing.assert_allclose(got.to_dense(), want.to_dense(),
                                   rtol=RTOL, atol=0)
        y = got.to_dense()
        reads5 = np.zeros(200, bool)
        reads5[I[J == 5]] = True
        if case == "wide":
            assert np.isfinite(y).all() and (y[100:] < 1e4).all()
        else:
            assert np.isfinite(y[~reads5]).all() and not np.isfinite(
                y[reads5]).any()


def test_mxv_reads_u_pattern_each_call():
    """An in-place edit of u's pattern between calls moves ``mxv`` from
    the dense-x engine to the sparse-x engine, with the JAX package's
    answer."""
    (Aj, At), _, _ = _rand_both(12, 10, 0.4, 31)
    x = np.arange(1.0, 11.0)
    ut = gt.Vector.from_dense(x, device="cpu")
    sr = gt.semiring.plus_times[gt.FP64]
    gt.mxv(gt.Vector.new(gt.FP64, 12, device="cpu"), None, None, sr, At, ut)
    assert gt.last_axb_method() == "spmv:dense_x"
    ut.pattern[[2, 7]] = False
    got = gt.mxv(gt.Vector.new(gt.FP64, 12, device="cpu"), None, None, sr,
                 At, ut)
    assert gt.last_axb_method() == "spmv:sparse_x"
    pat = np.ones(10, bool)
    pat[[2, 7]] = False
    want = gb.mxv(gb.Vector.new(gb.FP64, 12), None, None,
                  gb.semiring.plus_times[gb.FP64], Aj,
                  gb.Vector.from_dense(np.where(pat, x, 0), pattern=pat))
    _same_vec(got, want, exact=False)


def test_csr_mxv_int_matrix_float_semiring():
    """``test_sparse.py:391``: an int-stored A with a float semiring must
    not truncate x."""
    Aj, At = _both_csr([0, 1], [0, 1], np.array([2, 3], np.int32), 2, 2,
                       "INT32")
    x = np.array([0.5, 0.25])
    sr = gt.semiring.plus_times[gt.FP64]
    y, _ = gt.csr_mxv(sr, At, x)
    np.testing.assert_allclose(y.numpy(), [1.0, 0.75])
    yj, _ = jsp.csr_mxv(gb.semiring.plus_times[gb.FP64], Aj, jnp.asarray(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


@pytest.mark.parametrize("srname,ty", [
    ("plus_times", "FP32"), ("plus_times", "INT32"),
    ("plus_times", "UINT32"), ("min_plus", "INT32"),
    ("max_times", "FP32"), ("lor_land", "BOOL"),
    ("plus_pair", "INT32"), ("min_first", "FP32"),
])
def test_dense_x_matches_jax_sorted_route(monkeypatch, srname, ty):
    """``test_sparse.py:432``: where the JAX package takes its sort-routed
    engine, the port takes the dense-x engine; integers and booleans
    equal, floats within rtol=1e-6/atol=1e-7 as the JAX test holds its
    two engines."""
    import graphblas_tpu.sparse.pallas_spmv as pspmv_mod
    import graphblas_tpu.sparse.spmv as spmv_mod
    monkeypatch.setattr(pspmv_mod, "bsr_spmv_ok", lambda *a, **k: False)
    monkeypatch.setattr(spmv_mod, "_SORTED_MIN_LANES", 1)
    t = getattr(gb, ty)
    rng = np.random.default_rng(11)
    n, m, nz = 60, 45, 700
    I = rng.integers(0, n, nz)
    J = rng.integers(0, m, nz)
    if ty == "BOOL":
        X = np.ones(nz, bool)
        x = rng.random(m) > 0.4
    elif ty == "FP32":
        X = rng.normal(size=nz).astype(np.float32)
        x = rng.normal(size=m).astype(np.float32)
    else:
        X = rng.integers(1, 9, nz).astype(t.dtype)
        x = rng.integers(-4, 9, m).astype(t.dtype) if ty == "INT32" \
            else rng.integers(0, 9, m).astype(t.dtype)
    Aj, At = _both_csr(I, J, X, n, m, ty)
    srj, srt = _srs(srname, ty)
    assert spmv_mod._sorted_path_ok(srj, Aj)
    yj, pj = jsp.csr_mxv(srj, Aj, jnp.asarray(x))
    assert "_spmv_plan" in Aj._options          # the JAX sorted route ran
    yt, pt = gt.csr_mxv(srt, At, x)
    assert gt.last_axb_method() == "spmv:dense_x"
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    gj = np.where(np.asarray(pj), np.asarray(yj), 0)
    gt_ = np.where(pt.numpy(), yt.numpy().view(gj.dtype) if ty != "BOOL"
                   else yt.numpy(), 0)
    if ty == "FP32":
        np.testing.assert_allclose(gt_, gj, rtol=1e-6, atol=1e-7)
    else:
        assert np.array_equal(gt_, gj)


def test_dense_x_fp64_matches_oracle():
    """``test_sparse.py:475``: f64 dense x (which the JAX sorted route
    refuses) through the dense-x engine against the dense product."""
    rng = np.random.default_rng(3)
    I = rng.integers(0, 30, 200)
    J = rng.integers(0, 30, 200)
    Aj, At = _both_csr(I, J, rng.normal(size=200), 30, 30, "FP64")
    x = rng.normal(size=30)
    y, p = gt.csr_mxv(gt.semiring.plus_times[gt.FP64], At, x)
    D = np.zeros((30, 30))
    I2, J2, X2 = At.extractTuples()
    D[I2, J2] = X2
    assert np.array_equal(p.numpy(), np.diff(At.indptr.numpy()) > 0)
    np.testing.assert_allclose(np.where(p.numpy(), y.numpy(), 0), D @ x,
                               rtol=1e-12, atol=1e-12)


def test_mult_land_on_integers_is_logical():
    """A non-bool LAND multiply is logical: (a != 0) & (x != 0).  The
    JAX package's ``csr_mxv`` multiplies the values instead (a reference
    defect, ROADMAP.md queue 3); the port agrees with the JAX package's
    bitmap ``mxv``."""
    rng = np.random.default_rng(3)
    I = rng.integers(0, 6, 20)
    J = rng.integers(0, 5, 20)
    X = rng.integers(0, 4, 20).astype(np.int32)
    Aj, At = _both_csr(I, J, X, 6, 5, "INT32")
    x = rng.integers(0, 4, 5).astype(np.int32)
    srj, srt = _srs("plus_land", "INT32")
    yt, pt = gt.csr_mxv(srt, At, x)
    want = gb.mxv(gb.Vector.new(gb.INT32, 6), None, None, srj,
                  Aj.to_matrix(), gb.Vector.from_dense(x, gb.INT32))
    assert np.array_equal(pt.numpy(), want.pattern_np())
    assert np.array_equal(yt.numpy(), want.to_dense())
    yj, _ = jsp.csr_mxv(srj, Aj, jnp.asarray(x))
    assert not np.array_equal(np.asarray(yj), want.to_dense())


def _csc_both(nr, nc, nnz, seed):
    rng = np.random.default_rng(seed)
    I = rng.integers(0, nr, nnz)
    J = rng.integers(0, nc, nnz)
    X = rng.normal(size=nnz)
    Aj = JCsc.from_coo(I, J, X, nr, nc, type=gb.FP64)
    At = gt.CscMatrix.from_coo(I, J, X, nr, nc, type=gt.FP64, device="cpu")
    D = np.zeros((nr, nc))
    I2, J2, X2 = At.extractTuples()
    D[I2, J2] = X2
    return Aj, At, D


def test_csc_container_matches_jax():
    Aj, At, D = _csc_both(9, 5, 30, 0)
    assert At.shape == Aj.shape == (9, 5) and At.nvals == Aj.nvals
    for got, want in zip(At.extractTuples(), Aj.extractTuples()):
        assert np.array_equal(got, np.asarray(want))
    I, J, _ = At.extractTuples()
    assert np.all(np.diff(J * 9 + I) > 0)           # column order
    assert At.T() is At.tr                          # free transpose
    for got, want in zip(At.to_csr().extractTuples(),
                         Aj.to_csr().extractTuples()):
        assert np.array_equal(got, np.asarray(want))
    assert np.allclose(At.to_matrix().values.numpy(), D)
    assert np.array_equal(gt.CscMatrix.from_csr(At.to_csr()).tr.indices,
                          At.tr.indices)
    assert np.array_equal(convert.from_jax(Aj, device="cpu").tr.indptr,
                          At.tr.indptr)


@pytest.mark.parametrize("tran", [False, True])
def test_csc_mxv(tran):
    """``test_csc.py:66``."""
    Aj, At, D = _csc_both(10, 8, 40, 5)
    x = np.random.default_rng(9).normal(size=10 if tran else 8)
    sr = gt.semiring.plus_times[gt.FP64]
    dt, dj = (gt.TRAN0, JDescriptor(tran0=True)) if tran else (None, None)
    w = gt.mxv(gt.Vector.new(gt.FP64, 8 if tran else 10, device="cpu"),
               None, None, sr, At, gt.Vector.from_dense(x, device="cpu"), dt)
    want = (D.T @ x) if tran else (D @ x)
    pat = ((D.T != 0) if tran else (D != 0)).any(axis=1)
    np.testing.assert_allclose(np.where(w.pattern_np(), w.to_dense(), 0),
                               np.where(pat, want, 0), rtol=1e-12,
                               atol=1e-12)
    wj = gb.mxv(gb.Vector.new(gb.FP64, 8 if tran else 10), None, None,
                gb.semiring.plus_times[gb.FP64], Aj,
                gb.Vector.from_dense(x, gb.FP64), dj)
    _same_vec(w, wj, exact=False)


@pytest.mark.parametrize("tran", [False, True])
def test_csc_vxm(tran):
    """``test_csc.py:85``."""
    Aj, At, D = _csc_both(10, 8, 40, 6)
    x = np.random.default_rng(8).normal(size=8 if tran else 10)
    sr = gt.semiring.plus_times[gt.FP64]
    dt, dj = (gt.TRAN1, JDescriptor(tran1=True)) if tran else (None, None)
    w = gt.vxm(gt.Vector.new(gt.FP64, 10 if tran else 8, device="cpu"),
               None, None, sr, gt.Vector.from_dense(x, device="cpu"), At, dt)
    want = (x @ D.T) if tran else (x @ D)
    pat = (D != 0).any(axis=1) if tran else (D != 0).any(axis=0)
    np.testing.assert_allclose(np.where(w.pattern_np(), w.to_dense(), 0),
                               np.where(pat, want, 0), rtol=1e-12,
                               atol=1e-12)
    wj = gb.vxm(gb.Vector.new(gb.FP64, 10 if tran else 8), None, None,
                gb.semiring.plus_times[gb.FP64],
                gb.Vector.from_dense(x, gb.FP64), Aj, dj)
    _same_vec(w, wj, exact=False)


def _bitmap_both(rng, shape, density, tname):
    t = getattr(gb, tname)
    p = rng.random(shape) < density
    v = (rng.normal(size=shape) * 5).astype(t.dtype) * p
    if len(shape) == 1:
        return (gb.Vector.from_dense(v, t, pattern=p),
                gt.Vector.from_dense(v, getattr(gt, tname), pattern=p,
                                     device="cpu"))
    Mj = gb.Matrix.from_dense(v, t, pattern=p)
    return Mj, gt.Matrix(torch.from_numpy(t.dtype.type(0) + v),
                         torch.from_numpy(p), getattr(gt, tname))


@pytest.mark.parametrize("tname", ["FP64", "INT32"])
def test_mxv_vxm_bitmap(tname):
    """``test_mxm.py:81``: mxv/vxm on a bitmap Matrix."""
    rng = np.random.default_rng(42)
    Aj, At = _bitmap_both(rng, (5, 4), 0.6, tname)
    uj, ut = _bitmap_both(rng, (4,), 0.7, tname)
    vj, vt = _bitmap_both(rng, (5,), 0.7, tname)
    srj, srt = _srs("plus_times", tname)
    exact = tname != "FP64"
    got = gt.mxv(gt.Vector.new(srt.ztype, 5, device="cpu"), None, None, srt,
                 At, ut)
    want = gb.mxv(gb.Vector.new(srj.ztype, 5), None, None, srj, Aj, uj)
    _same_vec(got, want, exact)
    got2 = gt.vxm(gt.Vector.new(srt.ztype, 4, device="cpu"), None, None,
                  srt, vt, At)
    want2 = gb.vxm(gb.Vector.new(srj.ztype, 4), None, None, srj, vj, Aj)
    _same_vec(got2, want2, exact)


def test_vxm_csr_noncommutative_flip():
    """``test_api.py:473``: vxm on CSR flips the multiply so
    non-commutative ops keep their operand order."""
    rng = np.random.default_rng(80)
    mask = rng.random((6, 6)) < 0.6
    Ad = (rng.integers(1, 9, (6, 6)) * mask).astype(np.float64)
    I, J = np.nonzero(mask)
    Aj, At = _both_csr(I, J, Ad[I, J], 6, 6, "FP64")
    x = np.arange(1.0, 7.0)
    ut = gt.Vector.from_dense(x, device="cpu")
    for srname in ("plus_first", "plus_second", "min_minus", "max_div"):
        srj, srt = _srs(srname, "FP64")
        got = gt.vxm(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
                     srt, ut, At, gt.TRAN1)
        bit = gt.vxm(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
                     srt, ut, At.to_matrix(), gt.TRAN1)
        want = gb.vxm(gb.Vector.new(gb.FP64, 6), None, None, srj,
                      gb.Vector.from_dense(x), Aj, gb.TRAN1)
        _same_vec(got, want, exact=False)
        _same_vec(bit, want, exact=False)
    with pytest.raises(gt.DimensionMismatch):
        gt.mxv(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
               "plus_times", At, gt.Vector.from_dense(np.ones(5),
                                                      device="cpu"))


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("scmp", [False, True])
@pytest.mark.parametrize("accum", [None, "plus", "min"])
def test_mxv_mask_accum_matches_jax(accum, scmp, replace):
    """The bitmap epilogue after a CSR SpMV, sparse u."""
    rng = np.random.default_rng(12)
    (Aj, At), _, _ = _rand_both(14, 11, 0.3, 13)
    uj, ut = _bitmap_both(rng, (11,), 0.6, "FP64")
    wj0, wt0 = _bitmap_both(rng, (14,), 0.5, "FP64")
    mj, mt = _bitmap_both(rng, (14,), 0.5, "INT32")
    dj = JDescriptor(mask_scmp=scmp, replace=replace)
    dt = gt.Descriptor(mask_scmp=scmp, replace=replace)
    got = gt.mxv(wt0, mt, accum and gt.binary[accum][gt.FP64],
                 "plus_times", At, ut, dt)
    want = gb.mxv(wj0, mj, accum and gb.binary[accum][gb.FP64],
                  gb.semiring.plus_times[gb.FP64], Aj, uj, dj)
    _same_vec(got, want, exact=False)


def test_vxm_bfs_step_matches_jax():
    """One BFS step as users write it: vxm lor_land from a frontier with
    the complemented visited mask and REPLACE."""
    rng = np.random.default_rng(21)
    pat = rng.random((40, 40)) < 0.1
    pat = pat | pat.T
    I, J = np.nonzero(pat)
    Aj, At = _both_csr(I, J, np.ones(len(I), bool), 40, 40, "BOOL")
    q = np.zeros(40, bool)
    q[[3, 17]] = True
    qj = gb.Vector.from_dense(q, gb.BOOL, pattern=q)
    qt = gt.Vector.from_dense(q, gt.BOOL, pattern=q, device="cpu")
    dj = JDescriptor(mask_scmp=True, replace=True)
    dt = gt.Descriptor(mask_scmp=True, replace=True)
    got = gt.vxm(gt.Vector.new(gt.BOOL, 40, device="cpu"), qt, None,
                 "lor_land", qt, At, dt)
    assert gt.last_axb_method() == "spmv:sparse_x"
    want = gb.vxm(gb.Vector.new(gb.BOOL, 40), qj, None,
                  gb.semiring.lor_land[gb.BOOL], qj, Aj, dj)
    _same_vec(got, want, exact=True)
    assert np.array_equal(got.pattern_np(), pat[[3, 17]].any(0) & ~q)


def test_mxv_vector_containers_only():
    (_, At), _, _ = _rand_both(6, 6, 0.5, 2)
    u = gt.Vector.from_dense(np.ones(6), device="cpu")
    with pytest.raises(gt.UnsupportedContainer,
                       match="expected a Vector or a SparseVec"):
        gt.mxv(At, None, None, "plus_times", At, u)
    with pytest.raises(gt.UnsupportedContainer):
        gt.vxm(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
               "plus_times", At, At)
    with pytest.raises(gt.UnsupportedContainer):
        gt.mxv(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
               "plus_times", np.eye(6), u)
    with pytest.raises(gt.UnsupportedOp):
        gt.mxv(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
               "no_such", At, u)


def test_mxv_counted():
    from graphblas_tpu_torch.utils import counters
    (_, At), _, _ = _rand_both(6, 6, 0.5, 2)
    u = gt.Vector.from_dense(np.ones(6), device="cpu")
    counters.reset()
    gt.mxv(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
           "plus_times", At, u)
    gt.vxm(gt.Vector.new(gt.FP64, 6, device="cpu"), None, None,
           "plus_times", u, At)
    assert counters.stats()["ops"] == {"mxv": 1, "vxm": 1}
