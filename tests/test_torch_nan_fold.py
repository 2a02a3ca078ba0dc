"""PyTorch port, float MIN/MAX folds with NaN terms: every CSR engine
gives what the bitmap path gives.

The bitmap ``mxm``/``mxv`` (and K6, SpMM) fold MIN/MAX with fmin/fmax
from the add identity, so a NaN term drops out and an all-NaN fold holds
the identity.  The port's CSR engines (ESC through ``csr_spgemm``, the
dense-x and sparse-x SpMV engines) fold through
``sparse/spmv.py::segment_reduce`` and must agree with the JAX package's
bitmap ``mxm``/``mxv`` on the same inputs, exactly (min and max of
float32 sums are exact).  The JAX package's CSR engines propagate the
NaN instead: a reference defect (ROADMAP.md queue 3), recorded here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import spmv as tspmv

SEMIRINGS = ["min_plus", "max_plus"]
A_DENSE = np.array([[np.nan, 2], [1, 3]], np.float32)
B_DENSE = np.ones((2, 2), np.float32)


def _coo(D):
    I, J = np.nonzero(np.ones(D.shape, bool))
    return I, J, D[I, J]


def _csr_both(D, n=None):
    """D as FP32 CSR in both packages, in the top-left corner of an n x n
    matrix (default: D's own shape)."""
    I, J, X = _coo(D)
    m, k = D.shape if n is None else (n, n)
    return (jsp.CsrMatrix.from_coo(I, J, X, m, k, type=gb.FP32),
            gt.csr_from_coo(I, J, X, m, k, type=gt.FP32, device="cpu"))


def _srs(name):
    return gb.semiring[name][gb.FP32], gt.semiring[name][gt.FP32]


def _jax_bitmap_mxm(srj, A, B):
    C = gb.mxm(gb.Matrix.new(gb.FP32, A.shape[0], B.shape[1]), None, None,
               srj, gb.Matrix.from_dense(A, gb.FP32),
               gb.Matrix.from_dense(B, gb.FP32))
    return C.to_dense(), C.pattern_np()


def _jax_bitmap_mxv(srj, A, u, transpose=False):
    m = A.shape[1] if transpose else A.shape[0]
    w = gb.Vector.new(gb.FP32, m)
    Aj, uj = gb.Matrix.from_dense(A, gb.FP32), gb.Vector.from_dense(u,
                                                                     gb.FP32)
    w = (gb.vxm(w, None, None, srj, uj, Aj) if transpose
         else gb.mxv(w, None, None, srj, Aj, uj))
    return w.to_dense(), w.pattern_np()


def _dense_of(C):
    I, J, X = C.extractTuples()
    D = np.zeros(C.shape, np.float32)
    P = np.zeros(C.shape, bool)
    D[I, J], P[I, J] = X, True
    return D, P


@pytest.mark.parametrize("name", SEMIRINGS)
def test_bitmap_reference_ignores_nan(name):
    """The JAX bitmap ``mxm`` drops the NaN term (row 0 is 3 from 2 + 1)
    and an all-NaN fold holds the identity; the port's bitmap path
    agrees."""
    srj, srt = _srs(name)
    want, _ = _jax_bitmap_mxm(srj, A_DENSE, B_DENSE)
    assert np.array_equal(want[0], [3, 3])
    got = gt.mxm(gt.Matrix.new(gt.FP32, 2, 2, device="cpu"), None, None,
                 srt, gt.Matrix.from_dense(A_DENSE, gt.FP32, device="cpu"),
                 gt.Matrix.from_dense(B_DENSE, gt.FP32, device="cpu"))
    assert np.array_equal(got.to_dense(), want)
    one, _ = _jax_bitmap_mxm(srj, np.full((1, 1), np.nan, np.float32),
                             np.ones((1, 1), np.float32))
    ident = np.inf if name == "min_plus" else -np.inf
    assert one[0, 0] == ident


@pytest.mark.parametrize("name", SEMIRINGS)
def test_csr_spgemm_matches_jax_bitmap(name):
    srj, srt = _srs(name)
    want, wpat = _jax_bitmap_mxm(srj, A_DENSE, B_DENSE)
    (Aj, At), (Bj, Bt) = _csr_both(A_DENSE), _csr_both(B_DENSE)
    got, gpat = _dense_of(gt.csr_spgemm(srt, At, Bt))
    assert gt.last_axb_method() == "esc:csr_spgemm"
    assert np.array_equal(gpat, wpat)
    assert np.array_equal(got, want)
    # the reference's own CSR engine propagates the NaN (the defect)
    jd, _ = _dense_of(jsp.csr_spgemm(srj, Aj, Bj))
    assert np.isnan(jd[0]).all()


@pytest.mark.parametrize("name", SEMIRINGS)
def test_csr_spgemm_all_nan_segment_holds_identity(name):
    srj, srt = _srs(name)
    nan1 = np.full((1, 1), np.nan, np.float32)
    one = np.ones((1, 1), np.float32)
    want, _ = _jax_bitmap_mxm(srj, nan1, one)
    (_, At), (_, Bt) = _csr_both(nan1), _csr_both(one)
    got, pat = _dense_of(gt.csr_spgemm(srt, At, Bt))
    assert pat.all() and np.array_equal(got, want)
    assert not np.isnan(got).any()


@pytest.mark.parametrize("name", SEMIRINGS)
def test_mxm_n5000_esc_matches_jax_bitmap(name):
    """The same A and B placed in n = 5,000 CSR matrices: ``gt.mxm`` takes
    ESC, and its corner equals the JAX bitmap product."""
    srj, srt = _srs(name)
    want, wpat = _jax_bitmap_mxm(srj, A_DENSE, B_DENSE)
    n = 5000
    (_, At), (_, Bt) = _csr_both(A_DENSE, n), _csr_both(B_DENSE, n)
    e = np.zeros(0, np.int64)
    C0 = gt.csr_from_coo(e, e, np.zeros(0, np.float32), n, n, type=gt.FP32,
                         device="cpu")
    C = gt.mxm(C0, None, None, srt, At, Bt)
    assert gt.last_axb_method() == "esc:csr_spgemm"
    I, J, X = C.extractTuples()
    assert C.nvals == 4 and (I < 2).all() and (J < 2).all()
    got = np.zeros((2, 2), np.float32)
    got[I, J] = X
    assert wpat.all() and np.array_equal(got, want)


@pytest.mark.parametrize("sparse_x", [False, True])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_csr_mxv_matches_jax_bitmap(name, sparse_x):
    """Both SpMV engines (dense-x, and sparse-x when u's pattern is
    given) against the JAX bitmap ``mxv``; the reference's ``csr_mxv``
    gives NaN in row 0 (the defect)."""
    srj, srt = _srs(name)
    u = np.ones(2, np.float32)
    want, wpat = _jax_bitmap_mxv(srj, A_DENSE, u)
    assert np.array_equal(want, [3, 2] if name == "min_plus" else [3, 4])
    Aj, At = _csr_both(A_DENSE)
    xp = np.ones(2, bool) if sparse_x else None
    y, pat = gt.csr_mxv(srt, At, u, x_pattern=xp)
    assert gt.last_axb_method() == ("spmv:sparse_x" if sparse_x
                                    else "spmv:dense_x")
    assert np.array_equal(pat.numpy(), wpat)
    assert np.array_equal(y.numpy(), want)
    yj, _ = jsp.csr_mxv(srj, Aj, jnp.asarray(u))
    assert np.isnan(np.asarray(yj)[0])


@pytest.mark.parametrize("sparse_x", [False, True])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_csr_vxm_matches_jax_bitmap(name, sparse_x):
    """u' A through ``csr_vxm`` on Aᵀ in CSR, both engines, against the
    JAX bitmap ``vxm``."""
    srj, srt = _srs(name)
    u = np.ones(2, np.float32)
    want, wpat = _jax_bitmap_mxv(srj, A_DENSE, u, transpose=True)
    _, ATt = _csr_both(np.ascontiguousarray(A_DENSE.T))
    xp = np.ones(2, bool) if sparse_x else None
    y, pat = gt.csr_vxm(srt, u, ATt, x_pattern=xp)
    assert np.array_equal(pat.numpy(), wpat)
    assert np.array_equal(y.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["MIN", "MAX"])
def test_segment_reduce_float_nan_drops_out(name, dtype):
    """Segments [nan, 2], [nan], [] and [1, nan, 5]: NaN drops out, an
    all-NaN or empty segment holds the identity."""
    ident = np.inf if name == "MIN" else -np.inf
    vals = torch.tensor([np.nan, 2, np.nan, 1, np.nan, 5], dtype=dtype)
    seg = torch.tensor([0, 0, 1, 3, 3, 3])
    got = tspmv.segment_reduce(name, vals, seg, 4, ident)
    pick = min if name == "MIN" else max
    assert got.tolist() == [2, ident, ident, pick(1, 5)]
