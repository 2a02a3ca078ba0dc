"""PyTorch port, the SpMM fast path (``sparse/spmm.py``: CSR x dense
bitmap into a bitmap ``Matrix``): a mirror of ``tests/test_spmm.py`` in
parity with the JAX package's ``gb.mxm``, ``spmm:ell`` on both sides.

Patterns and integer or boolean values must be equal exactly; FP64
values within rtol=1e-12, atol=1e-12 (the two packages reduce a row's
terms in different orders)."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.ops import flopcount as jfc
from graphblas_tpu.sparse import spmm as jspmm
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.sparse import spmm as tspmm


def _rand_csr(m, n, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    vals = rng.normal(size=(m, n)) * mask
    I, J = np.nonzero(mask)
    Aj = jsp.CsrMatrix.from_coo(I, J, vals[I, J], m, n, type=gb.FP64)
    return Aj, convert.from_jax(Aj, device="cpu")


def _dense_b(n, k, seed, holes=False):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, k))
    pat = (rng.random((n, k)) < 0.7) if holes else np.ones((n, k), bool)
    return (gb.Matrix.from_dense(vals, gb.FP64, pattern=pat),
            gt.Matrix.from_dense(vals, gt.FP64, pattern=pat, device="cpu"))


def _same(got, want, tol=1e-12):
    assert isinstance(got, gt.Matrix)
    assert np.array_equal(got.pattern_np(), want.pattern_np())
    a, b = got.to_dense(), want.to_dense()
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    else:
        assert np.array_equal(a, b)


def _both(Cj, Ct, Mj, Mt, accj, acct, srj, srt, Aj, At, Bj, Bt, desc=None):
    want = gb.mxm(Cj, Mj, accj, srj, Aj, Bj,
                  gb.Descriptor(**desc) if desc else None)
    assert jfc.last_axb_method() == "spmm:ell"
    got = gt.mxm(Ct, Mt, acct, srt, At, Bt,
                 gt.Descriptor(**desc) if desc else None)
    assert gt.last_axb_method() == "spmm:ell"
    return got, want


@pytest.mark.parametrize("srname", ["plus_times", "min_plus", "max_first",
                                    "plus_pair", "max_second", "times_plus"])
def test_spmm_semirings(srname):
    Aj, At = _rand_csr(60, 45, 0.15, 3)
    Bj, Bt = _dense_b(45, 17, 4)
    got, want = _both(gb.Matrix.new(gb.FP64, 60, 17),
                      gt.Matrix.new(gt.FP64, 60, 17, device="cpu"), None,
                      None, None, None, gb.semiring[srname][gb.FP64],
                      gt.semiring[srname][gt.FP64], Aj, At, Bj, Bt)
    _same(got, want)


def test_spmm_holes_mask_accum_transpose():
    Aj, At = _rand_csr(40, 40, 0.2, 5)
    Bj, Bt = _dense_b(40, 9, 6, holes=True)
    rng = np.random.default_rng(7)
    Mpat = rng.random((40, 9)) < 0.5
    I, J = np.nonzero(Mpat)
    Mj = gb.Matrix.from_coo(I, J, np.ones(len(I)), 40, 9, type=gb.BOOL)
    Mt = gt.Matrix.from_coo(I, J, np.ones(len(I)), 40, 9, type=gt.BOOL,
                            device="cpu")
    c0 = rng.normal(size=(40, 9))
    got, want = _both(gb.Matrix.from_dense(c0, gb.FP64),
                      gt.Matrix.from_dense(c0, gt.FP64, device="cpu"), Mj, Mt,
                      gb.binary.plus[gb.FP64], gt.binary.plus[gt.FP64],
                      gb.semiring.plus_times[gb.FP64],
                      gt.semiring.plus_times[gt.FP64], Aj, At, Bj, Bt,
                      dict(tran0=True, replace=True))
    _same(got, want)


def test_spmm_tran1_and_csc():
    """TRAN1 on B (the transposed bitmap) and a CscMatrix A."""
    Aj, At = _rand_csr(30, 20, 0.25, 8)
    Bj, Bt = _dense_b(11, 20, 9, holes=True)
    got, want = _both(gb.Matrix.new(gb.FP64, 30, 11),
                      gt.Matrix.new(gt.FP64, 30, 11, device="cpu"), None,
                      None, None, None, gb.semiring.min_plus[gb.FP64],
                      gt.semiring.min_plus[gt.FP64], Aj, At, Bj, Bt,
                      dict(tran1=True))
    _same(got, want)
    Acj = jsp.CscMatrix.from_csr(Aj)
    Act = gt.CscMatrix.from_csr(At)
    got2, want2 = _both(gb.Matrix.new(gb.FP64, 30, 11),
                        gt.Matrix.new(gt.FP64, 30, 11, device="cpu"), None,
                        None, None, None, gb.semiring.min_plus[gb.FP64],
                        gt.semiring.min_plus[gt.FP64], Acj, Act, Bj, Bt,
                        dict(tran1=True))
    _same(got2, want2)
    _same(got2, want)


def test_spmm_bool_and_int():
    rng = np.random.default_rng(8)
    Ap = rng.random((30, 25)) < 0.2
    I, J = np.nonzero(Ap)
    Aj = jsp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), 30, 25,
                                type=gb.BOOL)
    Bv = rng.random((25, 6)) < 0.5
    got, want = _both(gb.Matrix.new(gb.BOOL, 30, 6),
                      gt.Matrix.new(gt.BOOL, 30, 6, device="cpu"), None, None,
                      None, None, gb.semiring.lor_land[gb.BOOL],
                      gt.semiring.lor_land[gt.BOOL], Aj,
                      convert.from_jax(Aj, device="cpu"),
                      gb.Matrix.from_dense(Bv, gb.BOOL),
                      gt.Matrix.from_dense(Bv, gt.BOOL, device="cpu"))
    _same(got, want)
    assert np.array_equal(got.to_dense(),
                          (Ap.astype(int) @ Bv.astype(int)) > 0)
    Xi = rng.integers(-9, 9, len(I)).astype(np.int32)
    Aij = jsp.CsrMatrix.from_coo(I, J, Xi, 30, 25, type=gb.INT32)
    Bi = rng.integers(-9, 9, (25, 6)).astype(np.int32)
    got, want = _both(gb.Matrix.new(gb.INT32, 30, 6),
                      gt.Matrix.new(gt.INT32, 30, 6, device="cpu"), None,
                      None, None, None, gb.semiring.plus_times[gb.INT32],
                      gt.semiring.plus_times[gt.INT32], Aij,
                      convert.from_jax(Aij, device="cpu"),
                      gb.Matrix.from_dense(Bi, gb.INT32),
                      gt.Matrix.from_dense(Bi, gt.INT32, device="cpu"))
    _same(got, want)


def test_spmm_empty_rows_pattern():
    # rows with no entries are absent from the output pattern
    Aj = jsp.CsrMatrix.from_coo([1], [2], [3.0], 4, 5, type=gb.FP64)
    got, want = _both(gb.Matrix.new(gb.FP64, 4, 3),
                      gt.Matrix.new(gt.FP64, 4, 3, device="cpu"), None, None,
                      None, None, gb.semiring.plus_times[gb.FP64],
                      gt.semiring.plus_times[gt.FP64], Aj,
                      convert.from_jax(Aj, device="cpu"),
                      gb.Matrix.from_dense(np.ones((5, 3)), gb.FP64),
                      gt.Matrix.from_dense(np.ones((5, 3)), gt.FP64,
                                           device="cpu"))
    _same(got, want)
    pat = got.pattern_np()
    assert pat[1].all() and not pat[[0, 2, 3]].any()


def test_spmm_plan_matches_jax():
    """The bucketed-ELL plan: the same slot layout and buckets."""
    rng = np.random.default_rng(10)
    deg = rng.integers(0, 40, 70)
    I = np.repeat(np.arange(70), deg)
    J = rng.integers(0, 50, len(I))
    Aj = jsp.CsrMatrix.from_coo(I, J, np.ones(len(I)), 70, 50, type=gb.FP64)
    At = convert.from_jax(Aj, device="cpu")
    pj, pt = jspmm.spmm_plan(Aj), tspmm.spmm_plan(At)
    assert pt.buckets == pj.buckets and pt.nslots == pj.nslots
    for name in ("cols_slot", "perm", "rowids"):
        assert np.array_equal(getattr(pt, name).numpy(),
                              np.asarray(getattr(pj, name)))
    assert tspmm.spmm_plan(At) is pt          # cached on the container
    assert torch.equal(pt.perm, tspmm.spmm_plan(
        gt.csr_from_coo(I, J, np.ones(len(I)), 70, 50, device="cpu")).perm)
