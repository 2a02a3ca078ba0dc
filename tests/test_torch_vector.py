"""PyTorch port, the bitmap ``Vector`` and the bitmap accum/mask
epilogue (``core/mask.py``): parity with the JAX package.

The same numpy-seeded inputs build a JAX ``Vector`` and the port's;
patterns, integers and booleans must be equal, floats too (the
epilogue only selects and casts, it does not reassociate).
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.core import mask as jmask
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.core import mask as tmask
from graphblas_tpu_torch.core.resolve import resolve_accum, resolve_semiring

TYPES = ["BOOL", "INT8", "UINT8", "INT32", "UINT32", "INT64", "UINT64",
         "FP32", "FP64"]


def _vals(rng, n, tname):
    t = getattr(gb, tname)
    if tname == "BOOL":
        return rng.random(n) < 0.5
    if t.dtype.kind == "f":
        return (rng.normal(size=n) * 9).astype(t.dtype)
    info = np.iinfo(t.dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), n,
                        dtype=np.int64).astype(t.dtype)


def _same(vt, vj):
    assert vt.type.name == vj.type.name
    assert vt.size == vj.size and vt.shape == tuple(vj.shape)
    assert np.array_equal(vt.pattern_np(), vj.pattern_np())
    a, b = vt.to_dense(), vj.to_dense()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    It, Xt = vt.extractTuples()
    Ij, Xj = vj.extractTuples()
    assert np.array_equal(It, Ij) and np.array_equal(Xt, Xj)
    assert vt.nvals() == vj.nvals()


@pytest.mark.parametrize("tname", TYPES)
def test_from_dense_matches_jax(tname):
    rng = np.random.default_rng(1)
    x = _vals(rng, 17, tname)
    pat = rng.random(17) < 0.6
    t_j, t_t = getattr(gb, tname), getattr(gt, tname)
    _same(gt.Vector.from_dense(x, t_t, device="cpu"),
          gb.Vector.from_dense(x, t_j))
    _same(gt.Vector.from_dense(x, t_t, pattern=pat, device="cpu"),
          gb.Vector.from_dense(x, t_j, pattern=pat))
    _same(gt.Vector.new(t_t, 9, device="cpu"), gb.Vector.new(t_j, 9))


@pytest.mark.parametrize("src,dst", [("FP64", "INT32"), ("FP32", "UINT8"),
                                     ("INT32", "BOOL"), ("UINT32", "FP64"),
                                     ("INT64", "INT8")])
def test_from_dense_casts_like_jax(src, dst):
    rng = np.random.default_rng(2)
    x = _vals(rng, 23, src)
    if src.startswith("FP"):
        x[:3] = [np.nan, 1e30, -1e30]
    _same(gt.Vector.from_dense(x, getattr(gt, dst), device="cpu"),
          gb.Vector.from_dense(x, getattr(gb, dst)))


@pytest.mark.parametrize("dup", [None, "plus", "first", "second", "min",
                                 "times", "minus"])
@pytest.mark.parametrize("tname", ["INT32", "FP64", "UINT16"])
def test_from_coo_dups_match_jax(dup, tname):
    """Duplicates fold in input order with the dup op (default PLUS)."""
    rng = np.random.default_rng(3)
    I = rng.integers(0, 12, 40)
    X = _vals(rng, 40, tname)
    opj = gb.binary[dup][getattr(gb, tname)] if dup else None
    opt = gt.binary[dup][getattr(gt, tname)] if dup else None
    _same(gt.Vector.from_coo(I, X, 15, dup=opt, device="cpu"),
          gb.Vector.from_coo(I, X, 15, dup=opj))


def test_from_coo_bool_and_cast():
    I = np.array([4, 1, 4, 0])
    _same(gt.Vector.from_coo(I, [True, False, True, False], 6,
                             device="cpu"),
          gb.Vector.from_coo(I, [True, False, True, False], 6))
    X = np.array([2.7, -1.5, 3.9, 0.2])
    _same(gt.Vector.from_coo(I, X, 6, type=gt.INT16, device="cpu"),
          gb.Vector.from_coo(I, X, 6, type=gb.INT16))
    with pytest.raises(gt.IndexOutOfBounds):
        gt.Vector.from_coo([6], [1.0], 6, device="cpu")


def test_vector_methods():
    x = np.array([1.5, 0.0, -2.0, 4.0])
    pat = np.array([True, False, True, True])
    v = gt.Vector.from_dense(x, gt.FP64, pattern=pat, device="cpu")
    assert v.wait() is v
    d = v.dup()
    assert d is not v and torch.equal(d.values, v.values)
    assert v.clear().nvals() == 0 and v.clear().size == 4
    np.testing.assert_array_equal(v.to_dense(fill=-1.0), [1.5, -1.0, -2.0,
                                                          4.0])
    assert not v.all_present()
    assert gt.Vector.from_dense(x, device="cpu").all_present()
    assert gt.Vector.from_dense(torch.ones(3)).device.type == "cpu"
    with pytest.raises(gt.DimensionMismatch):
        gt.Vector.from_dense(x, pattern=np.ones(3, bool), device="cpu")
    with pytest.raises(ValueError):
        gt.Vector(torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.bool),
                  gt.FP32)


def test_vector_needs_a_device():
    """The constructor policy: no device and no card raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.Vector.new(gt.FP32, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.Vector.from_dense(np.ones(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.Vector.from_coo([0], [1.0], 3)


@pytest.mark.parametrize("tname", ["FP32", "UINT32", "BOOL"])
def test_vector_from_jax(tname):
    rng = np.random.default_rng(4)
    x = _vals(rng, 11, tname)
    vj = gb.Vector.from_dense(x, getattr(gb, tname),
                              pattern=rng.random(11) < 0.5)
    _same(convert.from_jax(vj, device="cpu"), vj)


def test_resolve_from_vector_operand():
    """Catalog names take their type from a vector operand."""
    v = gt.Vector.new(gt.INT16, 3, device="cpu")
    assert resolve_semiring("plus_times", "s", None, v).ztype == gt.INT16
    assert resolve_accum("max", "a", None, v).xtype == gt.INT16


def _pair(rng, n, tname, density=0.5):
    x = _vals(rng, n, tname)
    p = rng.random(n) < density
    return (gb.Vector.from_dense(x, getattr(gb, tname), pattern=p),
            gt.Vector.from_dense(x, getattr(gt, tname), pattern=p,
                                 device="cpu"))


@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("scmp", [False, True])
@pytest.mark.parametrize("accum", [None, "plus", "second", "max"])
def test_accum_mask_matches_jax(accum, scmp, replace, structural):
    """``core/mask.py``: C<M> = accum(C, T) on vectors, every descriptor
    combination, against the JAX package's epilogue."""
    rng = np.random.default_rng(5)
    Cj, Ct = _pair(rng, 30, "FP64")
    Tj, Tt = _pair(rng, 30, "INT32")
    Mj, Mt = _pair(rng, 30, "INT8")        # explicit zeros in the mask
    dj = gb.Descriptor(mask_scmp=scmp, replace=replace,
                       mask_structure=structural)
    dt = gt.Descriptor(mask_scmp=scmp, replace=replace,
                       mask_structure=structural)
    acc_j = gb.binary[accum][gb.FP64] if accum else None
    acc_t = gt.binary[accum][gt.FP64] if accum else None
    for mj, mt in ((Mj, Mt), (None, None)):
        _same(tmask.accum_mask(Ct, mt, Tt, acc_t, dt),
              jmask.accum_mask(Cj, mj, Tj, acc_j, dj))


def test_effective_mask_matches_jax():
    rng = np.random.default_rng(6)
    Mj, Mt = _pair(rng, 25, "FP32")
    for scmp in (False, True):
        for structural in (False, True):
            got = tmask.effective_mask(Mt, scmp, structural)
            want = jmask.effective_mask(Mj, scmp, structural)
            assert np.array_equal(got.numpy(), np.asarray(want))
    assert tmask.effective_mask(None, True, False) is None


def test_accum_mask_checks_shapes():
    rng = np.random.default_rng(7)
    _, Ct = _pair(rng, 6, "FP64")
    _, Tt = _pair(rng, 5, "FP64")
    with pytest.raises(gt.DimensionMismatch):
        tmask.accum_mask(Ct, None, Tt, None, None)
    _, Mt = _pair(rng, 5, "BOOL")
    with pytest.raises(gt.DimensionMismatch):
        tmask.accum_mask(Ct, Mt, Ct, None, None)
