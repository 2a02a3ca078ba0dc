"""PyTorch port, ``HyperCscMatrix``: the by-column hypersparse
orientation as a transpose wrapper.  Parity with the JAX package.

Mirrors ``tests/test_hyper_csc.py``: every op runs in the transposed
frame on the wrapped by-row container, on the port and on the JAX
package from the same numpy-seeded tuples; patterns and ids must be
equal exactly and FP64 values within rtol 1e-12.
"""

import numpy as np

import graphblas_tpu as gb
from graphblas_tpu.sparse import HyperCscMatrix as JHcsc
from graphblas_tpu.sparse import hyper_from_coo as jhyper
import graphblas_tpu_torch as gt

BIG = 1 << 40
CPU = "cpu"


def _pair(n=BIG, k=40, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(0, n, k), r.integers(0, n, k), r.random(k)


def _map(H):
    I, J, X = H.extractTuples()
    return {(int(i), int(j)): float(x) for i, j, x in
            zip(np.asarray(I), np.asarray(J), np.asarray(X))}


def same(Ht, Hj):
    """Same container kind, shape and entries (in storage order)."""
    assert type(Ht).__name__ == type(Hj).__name__
    assert Ht.shape == tuple(Hj.shape)
    for x, y in zip(Ht.extractTuples(), Hj.extractTuples()):
        y = np.asarray(y)
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(x, y)


def csc_both(I, J, X, m, n):
    return (gt.HyperCscMatrix.from_coo(I, J, X, m, n, type=gt.FP64,
                                       device=CPU),
            JHcsc.from_coo(I, J, X, m, n, type=gb.FP64))


def row_both(I, J, X, m, n):
    return (gt.hyper_from_coo(I, J, X, m, n, type=gt.FP64, device=CPU),
            jhyper(I, J, X, m, n, type=gb.FP64))


def empty_csc(m, n):
    e = np.array([], np.int64)
    return csc_both(e, e, np.array([], float), m, n)


def test_construct_and_metadata():
    I, J, X = _pair()
    At, Aj = csc_both(I, J, X, BIG, BIG)
    Rt, _ = row_both(I, J, X, BIG, BIG)
    assert At.shape == (BIG, BIG) and At.nvals == Rt.nvals
    assert At.nvec == Aj.nvec
    same(At, Aj)
    assert _map(At) == _map(Rt)
    T = At.T()
    assert isinstance(T, gt.HyperMatrix)
    assert _map(T) == {(j, i): v for (i, j), v in _map(Rt).items()}
    same(At.to_hyper(), Aj.to_hyper())
    assert _map(At.to_hyper()) == _map(Rt)
    assert _map(gt.HyperCscMatrix.from_hyper(Rt)) == _map(Rt)


def test_element_ops_2e40():
    def run(A, pkg):
        A = A.setElement(9.25, 7, BIG - 5).wait()
        got = [A.extractElement(7, BIG - 5), A.extractElement(1, BIG - 1)]
        A = A.removeElement(1, BIG - 1).wait()
        got += [A.extractElement(1, BIG - 1), A.nvals]
        return A, got
    args = (np.array([1, BIG - 2]), np.array([BIG - 1, 3]),
            np.array([1.5, 2.5]), BIG, BIG)
    At, Aj = csc_both(*args)
    (Bt, gt_got), (Bj, gj_got) = run(At, gt), run(Aj, gb)
    assert gt_got == gj_got == [9.25, 1.5, None, 2]
    same(Bt, Bj)


def test_ewise_add_masked_matches_by_row():
    n = 1 << 30
    I1, J1, X1 = _pair(n, 30, seed=1)
    I2, J2, X2 = _pair(n, 30, seed=2)
    MI = np.concatenate([I1[:15], I2[:15]])
    MJ = np.concatenate([J1[:15], J2[:15]])
    At, Aj = csc_both(I1, J1, X1, n, n)
    Bt, Bj = csc_both(I2, J2, X2, n, n)
    Mt = gt.HyperCscMatrix.from_coo(MI, MJ, np.ones(len(MI), bool), n, n,
                                    type=gt.BOOL, dup="max", device=CPU)
    Mj = JHcsc.from_coo(MI, MJ, np.ones(len(MI), bool), n, n, type=gb.BOOL,
                        dup="lor")
    Ct, Cj = empty_csc(n, n)
    got = gt.eWiseAdd(Ct, Mt, None, gt.binary.plus[gt.FP64], At, Bt)
    assert isinstance(got, gt.HyperCscMatrix)
    same(got, gb.eWiseAdd(Cj, Mj, None, gb.binary.plus[gb.FP64], Aj, Bj))
    # the by-row result of the same operation
    Ar, _ = row_both(I1, J1, X1, n, n)
    Br, _ = row_both(I2, J2, X2, n, n)
    Mr = gt.hyper_from_coo(MI, MJ, np.ones(len(MI), bool), n, n,
                           type=gt.BOOL, dup="max", device=CPU)
    e = np.array([], np.int64)
    Cr = gt.hyper_from_coo(e, e, np.array([], float), n, n, type=gt.FP64,
                           device=CPU)
    want = gt.eWiseAdd(Cr, Mr, None, gt.binary.plus[gt.FP64], Ar, Br)
    assert _map(got) == _map(want)


def test_apply_select_reduce():
    n = 1 << 35
    I, J, X = _pair(n, 25, seed=3)
    At, Aj = csc_both(I, J, X, n, n)
    Et, Ej = empty_csc(n, n)
    same(gt.apply(Et, None, None, gt.unary.ainv[gt.FP64], At),
         gb.apply(Ej, None, None, gb.unary.ainv[gb.FP64], Aj))
    # tril is index-dependent: the transposed frame must apply it to
    # the ORIGINAL coordinates
    got = gt.select(Et, None, None, gt.selectop.tril, At, 0)
    same(got, gb.select(Ej, None, None, gb.selectop.tril, Aj, 0))
    assert all(j <= i for i, j in _map(got))
    s1 = gt.reduce(None, gt.monoid.plus[gt.FP64], At)
    s2 = gb.reduce(None, gb.monoid.plus[gb.FP64], Aj)
    assert abs(s1 - s2) < 1e-12
    # reduce_to_vector into a SparseVec from a by-column input
    w = gt.SparseVec.from_coo([], np.zeros(0), n, type=gt.FP64, device=CPU)
    wj = gb.sparse.SparseVec.from_coo([], np.zeros(0), n, type=gb.FP64)
    got = gt.reduce_to_vector(w, None, None, gt.monoid.plus[gt.FP64], At)
    want = gb.reduce_to_vector(wj, None, None, gb.monoid.plus[gb.FP64], Aj)
    same(got.hm, want.hm)


def test_mxm_by_col_output():
    n = 200
    r = np.random.default_rng(5)
    I = r.integers(0, n, 150)
    J = r.integers(0, n, 150)
    X = r.random(150)
    At, Aj = csc_both(I, J, X, n, n)
    Ct, Cj = empty_csc(n, n)
    got = gt.mxm(Ct, None, None, gt.semiring.plus_times[gt.FP64], At, At)
    assert isinstance(got, gt.HyperCscMatrix)
    same(got, gb.mxm(Cj, None, None, gb.semiring.plus_times[gb.FP64],
                     Aj, Aj))
    D = np.zeros((n, n))
    np.add.at(D, (I, J), X)
    want = D @ D
    for (i, j), v in _map(got).items():
        assert abs(v - want[i, j]) < 1e-9
    # non-commutative multiply keeps its operand order (C' = B'A' flips)
    sr_t = gt.semiring.plus_minus[gt.FP64]
    sr_j = gb.semiring.plus_minus[gb.FP64]
    Bt, Bj = csc_both(J, I, X[::-1].copy(), n, n)
    same(gt.mxm(Ct, None, None, sr_t, At, Bt),
         gb.mxm(Cj, None, None, sr_j, Aj, Bj))


def test_assign_subassign_extract():
    n = 1 << 30
    I, J, X = _pair(n, 20, seed=7)
    At, Aj = csc_both(I, J, X, n, n)
    rows = np.array([5, n - 3, 77])
    cols = np.array([n - 1, 12])
    sub = np.arange(6, dtype=float).reshape(3, 2)
    SI, SJ = np.nonzero(sub + 1)
    St, Sj = csc_both(SI, SJ, sub[SI, SJ], 3, 2)
    got = gt.subassign(At, None, None, St, rows, cols)
    assert isinstance(got, gt.HyperCscMatrix)
    same(got, gb.subassign(Aj, None, None, Sj, rows, cols))
    same(gt.assign(At, None, None, St, rows, cols),
         gb.assign(Aj, None, None, Sj, rows, cols))
    Et, Ej = empty_csc(3, 2)
    same(gt.extract(Et, None, None, At, rows, cols),
         gb.extract(Ej, None, None, Aj, rows, cols))


def test_transpose_op_and_import_export():
    n = 1 << 33
    I, J, X = _pair(n, 15, seed=9)
    Rt, Rj = row_both(I, J, X, n, n)
    Et, Ej = empty_csc(n, n)
    got = gt.transpose(Et, None, None, Rt)
    assert isinstance(got, gt.HyperCscMatrix)
    same(got, gb.transpose(Ej, None, None, Rj))
    assert _map(got) == {(j, i): v for (i, j), v in _map(Rt).items()}
    Ac = gt.HyperCscMatrix.from_hyper(Rt)
    out = gt.export_hyper_csc(Ac)
    outj = gb.export_hyper_csc(JHcsc.from_hyper(Rj))
    for x, y in zip(out, outj):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    back = gt.import_hyper_csc(*out, type=gt.FP64, device=CPU)
    assert _map(back) == _map(Rt)
    # at a small dimension the port wraps a HyperMatrix (the JAX package
    # wraps the conformed container, a CsrMatrix here, which has no nvec)
    small = gt.import_hyper_csc(64, 64, 40, np.arange(40), np.arange(41),
                                np.arange(40), np.ones(40), type=gt.FP64,
                                device=CPU)
    assert isinstance(small.tr, gt.HyperMatrix) and small.nvec == 40
    assert type(gb.import_hyper_csc(64, 64, 40, np.arange(40),
                                    np.arange(41), np.arange(40),
                                    np.ones(40), type=gb.FP64).tr
                ).__name__ == "CsrMatrix"
    # a by-row container exports its transpose's hyper-CSR form
    for x, y in zip(gt.export_hyper_csc(Rt), gb.export_hyper_csc(Rj)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_mxv_vxm_with_hyper_csc_input():
    """A HyperCscMatrix as an mxv/vxm input at modest dimension (the
    bitmap route)."""
    n = 64
    r = np.random.default_rng(11)
    I = r.integers(0, n, 200)
    J = r.integers(0, n, 200)
    lin = np.unique(I * n + J)
    I, J = lin // n, lin % n
    X = r.random(len(I))
    At, Aj = csc_both(I, J, X, n, n)
    D = np.zeros((n, n))
    D[I, J] = X
    ut = gt.Vector.from_dense(np.arange(n, dtype=float), device=CPU)
    uj = gb.Vector.from_dense(np.arange(n, dtype=float))
    w = gt.mxv(gt.Vector.new(gt.FP64, n, device=CPU), None, None,
               gt.semiring.plus_times[gt.FP64], At, ut)
    wj = gb.mxv(gb.Vector.new(gb.FP64, n), None, None,
                gb.semiring.plus_times[gb.FP64], Aj, uj)
    np.testing.assert_allclose(w.to_dense(), np.asarray(wj.to_dense()),
                               rtol=1e-12)
    np.testing.assert_allclose(w.to_dense(), D @ np.arange(n), rtol=1e-12)
    w2 = gt.vxm(gt.Vector.new(gt.FP64, n, device=CPU), None, None,
                gt.semiring.plus_times[gt.FP64], ut, At)
    np.testing.assert_allclose(w2.to_dense(), np.arange(n) @ D, rtol=1e-12)
