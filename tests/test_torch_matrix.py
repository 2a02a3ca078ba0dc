"""PyTorch port, the bitmap ``Matrix`` (``core/matrix.py``): parity with
the JAX package's ``Matrix``.

The same numpy-seeded inputs build a JAX ``Matrix`` and the port's; the
shape, type, pattern and values must be equal exactly (construction only
casts, folds duplicates and moves entries: nothing is reassociated, and
the duplicate folds run in the same order on the host)."""

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert

TYPES = ["BOOL", "INT8", "UINT8", "INT16", "INT32", "UINT32", "INT64",
         "UINT64", "FP32", "FP64"]


def _vals(rng, shape, tname):
    t = getattr(gb, tname)
    if tname == "BOOL":
        return rng.random(shape) < 0.5
    if t.dtype.kind == "f":
        return (rng.normal(size=shape) * 9).astype(t.dtype)
    info = np.iinfo(t.dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), shape,
                        dtype=np.int64).astype(t.dtype)


def _same(mt, mj):
    """Port Matrix ``mt`` equals JAX Matrix ``mj``."""
    assert mt.type.name == mj.type.name
    assert mt.shape == tuple(mj.shape)
    assert (mt.nrows, mt.ncols) == (mj.nrows, mj.ncols)
    assert np.array_equal(mt.pattern_np(), mj.pattern_np())
    a, b = mt.to_dense(), mj.to_dense()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    for x, y in zip(mt.extractTuples(), mj.extractTuples()):
        assert np.array_equal(x, np.asarray(y), equal_nan=x.dtype.kind == "f")
    assert mt.nvals() == mj.nvals()


def _pair(rng, shape, tname, density=0.5):
    x = _vals(rng, shape, tname)
    p = rng.random(shape) < density
    return (gt.Matrix.from_dense(x, getattr(gt, tname), pattern=p,
                                 device="cpu"),
            gb.Matrix.from_dense(x, getattr(gb, tname), pattern=p))


@pytest.mark.parametrize("tname", TYPES)
def test_from_dense_matches_jax(tname):
    rng = np.random.default_rng(1)
    x = _vals(rng, (7, 9), tname)
    pat = rng.random((7, 9)) < 0.6
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    _same(gt.Matrix.from_dense(x, tt, device="cpu"),
          gb.Matrix.from_dense(x, tj))
    _same(gt.Matrix.from_dense(x, tt, pattern=pat, device="cpu"),
          gb.Matrix.from_dense(x, tj, pattern=pat))
    _same(gt.Matrix.new(tt, 4, 3, device="cpu"), gb.Matrix.new(tj, 4, 3))


@pytest.mark.parametrize("src,dst", [("FP64", "INT32"), ("FP32", "UINT8"),
                                     ("INT32", "BOOL"), ("UINT32", "FP64")])
def test_from_dense_casts_like_jax(src, dst):
    rng = np.random.default_rng(2)
    x = _vals(rng, (5, 6), src)
    if src.startswith("FP"):
        x[0, :3] = [np.nan, 1e30, -1e30]
    _same(gt.Matrix.from_dense(x, getattr(gt, dst), device="cpu"),
          gb.Matrix.from_dense(x, getattr(gb, dst)))


@pytest.mark.parametrize("dup", [None, "plus", "min", "first", "second",
                                 "minus"])
@pytest.mark.parametrize("tname", ["INT32", "FP64", "UINT16"])
def test_from_coo_dups_match_jax(dup, tname):
    """Duplicates fold in input order with the dup op (default PLUS;
    MINUS folds position by position)."""
    rng = np.random.default_rng(3)
    I, J = rng.integers(0, 6, 60), rng.integers(0, 5, 60)
    X = _vals(rng, 60, tname)
    opj = gb.binary[dup][getattr(gb, tname)] if dup else None
    opt = gt.binary[dup][getattr(gt, tname)] if dup else None
    _same(gt.Matrix.from_coo(I, J, X, 7, 5, dup=opt, device="cpu"),
          gb.Matrix.from_coo(I, J, X, 7, 5, dup=opj))


def test_from_coo_cast_bool_and_bounds():
    I, J = np.array([2, 0, 2, 1]), np.array([1, 3, 1, 0])
    X = np.array([2.7, -1.5, 3.9, 0.2])
    _same(gt.Matrix.from_coo(I, J, X, 3, 4, type=gt.INT16, device="cpu"),
          gb.Matrix.from_coo(I, J, X, 3, 4, type=gb.INT16))
    B = [True, False, True, False]
    _same(gt.Matrix.from_coo(I, J, B, 3, 4, device="cpu"),
          gb.Matrix.from_coo(I, J, B, 3, 4))
    with pytest.raises(gt.IndexOutOfBounds):
        gt.Matrix.from_coo([3], [0], [1.0], 3, 4, device="cpu")
    with pytest.raises(gt.IndexOutOfBounds):
        gt.Matrix.from_coo([0], [-1], [1.0], 3, 4, device="cpu")


def test_from_scipy_matches_jax():
    S = ssp.random(9, 7, density=0.3, random_state=4, format="csr")
    _same(gt.Matrix.from_scipy(S, device="cpu"), gb.Matrix.from_scipy(S))
    _same(gt.Matrix.from_scipy(S, type=gt.FP32, device="cpu"),
          gb.Matrix.from_scipy(S, type=gb.FP32))


@pytest.mark.parametrize("tname", ["FP64", "UINT32", "BOOL"])
def test_element_access_matches_jax(tname):
    rng = np.random.default_rng(5)
    mt, mj = _pair(rng, (6, 5), tname)
    for i in range(6):
        for j in range(5):
            got, want = mt.extractElement(i, j), mj.extractElement(i, j)
            assert (got is None) == (want is None)
            if want is not None:
                assert got == want and type(got) == type(want)
    I, J, _ = mj.extractTuples()
    i, j = int(I[0]), int(J[0])
    _same(mt.removeElement(i, j), mj.removeElement(i, j))
    _same(mt.removeElement(i, j).removeElement(i, j),
          mj.removeElement(i, j))
    for bad in ((6, 0), (0, 5), (-1, 0)):
        with pytest.raises(gt.IndexOutOfBounds):
            mt.extractElement(*bad)
        with pytest.raises(gt.IndexOutOfBounds):
            mt.removeElement(*bad)


@pytest.mark.parametrize("shape", [(3, 8), (9, 2), (6, 5), (10, 10)])
def test_resize_matches_jax(shape):
    rng = np.random.default_rng(6)
    mt, mj = _pair(rng, (6, 5), "INT32")
    _same(mt.resize(*shape), mj.resize(*shape))


@pytest.mark.parametrize("tname", ["FP32", "INT8", "BOOL"])
def test_transpose_clear_dup_iterate(tname):
    rng = np.random.default_rng(7)
    mt, mj = _pair(rng, (5, 8), tname, 0.4)
    _same(mt.T(), mj.T())
    _same(mt.clear(), mj.clear())
    assert mt.clear().nvals() == 0 and mt.clear().shape == (5, 8)
    d = mt.dup()
    assert d is not mt
    _same(d, mj.dup())
    assert mt.wait() is mt
    _same(mt.canonical(), mj.canonical())
    for (it, ct, vt), (ij, cj, vj) in zip(mt.rows(), mj.rows()):
        assert it == ij
        assert np.array_equal(ct, cj) and np.array_equal(vt, vj)
    assert len(list(mt.rows())) == len(list(mj.rows()))
    for (jt, rt, vt), (jj, rj, vj) in zip(mt.cols(), mj.cols()):
        assert jt == jj
        assert np.array_equal(rt, rj) and np.array_equal(vt, vj)
    assert len(list(mt.cols())) == len(list(mj.cols()))
    np.testing.assert_array_equal(mt.to_dense(fill=1),
                                  mj.to_dense(fill=1))


def test_matrix_needs_a_device():
    """The constructor policy: no device and no card raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.Matrix.new(gt.FP32, 2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.Matrix.from_dense(np.ones((2, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.Matrix.from_coo([0], [1], [1.0], 2, 3)
    # a tensor keeps its own device
    assert gt.Matrix.from_dense(torch.ones(2, 3)).device.type == "cpu"


def test_matrix_rejects_udt_and_bad_shapes():
    """A type that is not a GraphBLAS Type raises, and so do struct
    values without their user-defined type (user-defined types are
    ``Type.udt``, tests/test_torch_udt.py)."""
    with pytest.raises(TypeError, match="GraphBLAS Type"):
        gt.Matrix.new("my_struct", 2, 2, device="cpu")
    with pytest.raises(TypeError, match="user-defined"):
        gt.Matrix.from_dense({"x": np.ones((2, 2))}, device="cpu")
    with pytest.raises(gt.DimensionMismatch):
        gt.Matrix.from_dense(np.ones((2, 3)), pattern=np.ones((3, 2), bool),
                             device="cpu")
    with pytest.raises(ValueError):
        gt.Matrix(torch.zeros(3), torch.zeros(3, dtype=torch.bool), gt.FP32)


@pytest.mark.parametrize("tname", ["FP32", "UINT32", "BOOL", "INT64"])
def test_matrix_from_jax(tname):
    rng = np.random.default_rng(8)
    _, mj = _pair(rng, (4, 6), tname)
    _same(convert.from_jax(mj, device="cpu"), mj)
