"""PyTorch port, ``SparseVec``: the sparse vector at any dimension, a
vlen x 1 ``HyperMatrix``.  Parity with the JAX package.

Mirrors ``tests/test_sparse_vector.py``: every verb (mxv/vxm, eWise,
apply, reduce, assign/extract, setElement) runs on the port and on the
JAX package from the same numpy-seeded tuples; ids and values must be
equal (FP64 within rtol 1e-12) and match the dict oracle.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.sparse import SparseVec as JSv
from graphblas_tpu.sparse.hyper import HyperMatrix as JHyper
import graphblas_tpu_torch as gt

CPU = "cpu"


def sv(pkg, ids, vals, n, t="FP64", dup=None):
    ids = np.asarray(ids, np.int64)
    if pkg is gt:
        return gt.SparseVec.from_coo(ids, vals, n, type=getattr(gt, t),
                                     dup=dup, device=CPU)
    return JSv.from_coo(ids, vals, n, type=getattr(gb, t), dup=dup)


def d_of(v):
    ids, vals = v.extractTuples()
    return {int(i): float(x) for i, x in zip(np.asarray(ids),
                                             np.asarray(vals))}


def same(vt, vj):
    assert vt.size == vj.size and vt.nvals == vj.nvals
    for x, y in zip(vt.extractTuples(), vj.extractTuples()):
        y = np.asarray(y)
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(x, y)


def each(fn):
    """fn run with the port and with the JAX package."""
    return fn(gt), fn(gb)


def test_container_basics():
    def run(pkg):
        v = sv(pkg, [3, 7, 1], [1.0, 2.0, 3.0], 10)
        assert v.size == 10 and v.nvals == 3
        assert d_of(v) == {1: 3.0, 3: 1.0, 7: 2.0}
        v = v.setElement(9.0, 7).setElement(5.0, 0)
        got = [v.extractElement(7), v.extractElement(5)]
        v = v.removeElement(1)
        got.append(d_of(v))
        return v.resize(4), got
    (vt, gt_got), (vj, gj_got) = each(run)
    assert gt_got == gj_got == [9.0, None, {0: 5.0, 3: 1.0, 7: 9.0}]
    same(vt, vj)
    assert d_of(vt) == {0: 5.0, 3: 1.0}
    # dense round-trip
    w = gt.Vector.from_dense(np.array([0., 2., 0., 4.]),
                             pattern=np.array([False, True, False, True]),
                             device=CPU)
    s = gt.SparseVec.from_vector(w)
    assert d_of(s) == {1: 2.0, 3: 4.0} and s.ids().tolist() == [1, 3]
    back = s.to_vector()
    assert back.pattern_np().tolist() == [False, True, False, True]
    assert back.to_dense().tolist() == [0., 2., 0., 4.]
    with pytest.raises(gt.UnsupportedContainer, match="densify"):
        sv(gt, [1], [1.0], (1 << 26) + 1).to_vector()
    assert s.dup().nvals == 2 and s.clear().nvals == 0


def test_ewise_apply_select_reduce():
    def run(pkg):
        t = pkg.FP64
        a = sv(pkg, [1, 4, 6], [1.0, 2.0, 3.0], 9)
        b = sv(pkg, [4, 6, 8], [10.0, 20.0, 30.0], 9)
        z = sv(pkg, [], np.zeros(0), 9)
        m = sv(pkg, [4, 8], [1.0, 1.0], 9)
        return [pkg.eWiseAdd(z, None, None, pkg.binary.plus[t], a, b),
                pkg.eWiseMult(z, None, None, pkg.binary.times[t], a, b),
                pkg.apply(z, None, None, pkg.unary.ainv[t], a),
                pkg.select(z, None, None, pkg.selectop.nonzero, a),
                pkg.eWiseAdd(a, m, pkg.binary.plus[t], pkg.binary.plus[t],
                             a, b, pkg.Descriptor(replace=True))], \
            pkg.reduce_to_scalar(None, pkg.monoid.plus[t], a)
    (outs_t, s_t), (outs_j, s_j) = each(run)
    for x, y in zip(outs_t, outs_j):
        same(x, y)
    assert [d_of(x) for x in outs_t] == [
        {1: 1.0, 4: 12.0, 6: 23.0, 8: 30.0}, {4: 20.0, 6: 60.0},
        {1: -1.0, 4: -2.0, 6: -3.0}, {1: 1.0, 4: 2.0, 6: 3.0},
        {4: 14.0, 8: 30.0}]
    assert float(s_t) == float(s_j) == 6.0


def test_mxv_vxm_small_oracle():
    rng = np.random.default_rng(301)
    m, n = 6, 5
    D = np.where(rng.random((m, n)) < 0.5,
                 rng.integers(1, 9, (m, n)).astype(float), 0.0)
    I, J = np.nonzero(D)
    xd = np.where(rng.random(n) < 0.6, rng.integers(1, 9, n), 0)
    uD = np.where(rng.random(m) < 0.6, rng.integers(1, 9, m), 0)

    def run(pkg):
        t = pkg.FP64
        H = gt.HyperMatrix if pkg is gt else JHyper
        kw = {"device": CPU} if pkg is gt else {}
        A = H.from_coo(I, J, D[I, J], m, n, type=t, dup=None, **kw)
        x = sv(pkg, np.nonzero(xd)[0], xd[xd != 0].astype(float), n)
        u = sv(pkg, np.nonzero(uD)[0], uD[uD != 0].astype(float), m)
        y = pkg.mxv(sv(pkg, [], np.zeros(0), m), None, None,
                    pkg.semiring.plus_times[t], A, x)
        # vxm with a non-commutative multiply (FIRST): w_j = sum of u_k
        # over edges (k, j)
        w = pkg.vxm(sv(pkg, [], np.zeros(0), n), None, None,
                    pkg.Semiring(pkg.monoid.plus[t], pkg.binary.first[t])
                    if pkg is gb else gt.core.semirings.Semiring(
                        gt.monoid.plus[t], gt.binary.first[t]), u, A)
        # mxv through A' with a mask and accum
        mk = sv(pkg, [0, 2, 4], [1.0, 1.0, 1.0], n)
        z = pkg.mxv(x, mk, pkg.binary.plus[t], pkg.semiring.plus_times[t],
                    A, u, pkg.Descriptor(tran0=True))
        return y, w, z
    outs_t, outs_j = each(run)
    for x, y in zip(outs_t, outs_j):
        same(x, y)
    y, w, _ = outs_t
    want = D @ xd
    rowp = ((D != 0) & (xd != 0)[None, :]).any(axis=1)
    assert d_of(y) == {int(i): float(want[i]) for i in np.nonzero(rowp)[0]}
    want = ((D != 0) * uD[:, None]).sum(axis=0)
    colp = ((D != 0) & (uD != 0)[:, None]).any(axis=0)
    assert d_of(w) == {int(j): float(want[j]) for j in np.nonzero(colp)[0]}


def test_assign_extract_vector():
    def run(pkg):
        v = sv(pkg, [2, 5, 8], [1.0, 2.0, 3.0], 10)
        u = sv(pkg, [0, 1], [50.0, 60.0], 2)
        return (pkg.subassign_vector(v, None, None, u, np.array([5, 9])),
                pkg.assign_vector(v, None, None, u, np.array([9, 2])),
                pkg.assign_vector(v, None, None, 7.0, np.array([0, 3]),
                                  scalar=True),
                pkg.extract_vector(sv(pkg, [], np.zeros(0), 2), None, None,
                                   v, np.array([5, 2])))
    outs_t, outs_j = each(run)
    for x, y in zip(outs_t, outs_j):
        same(x, y)
    assert d_of(outs_t[0]) == {2: 1.0, 5: 50.0, 8: 3.0, 9: 60.0}
    assert d_of(outs_t[3]) == {0: 2.0, 1: 1.0}


def test_sparsevec_2p50_end_to_end():
    """Frontier-style ops at dimension 2^50."""
    dim = 1 << 50
    base = np.int64(999) << 31

    def run(pkg):
        t = pkg.FP64
        v = sv(pkg, base + np.array([1, 5, 9]), [1.0, 2.0, 3.0], dim)
        v = v.setElement(7.0, int(dim - 1))
        b = sv(pkg, base + np.array([5, 100]), [10.0, 20.0], dim)
        z = sv(pkg, [], np.zeros(0), dim)
        return (v.extractElement(int(dim - 1)),
                pkg.eWiseAdd(z, None, None, pkg.binary.plus[t], v, b),
                pkg.reduce_to_scalar(None, pkg.monoid.max[t], v))
    (et, gt_sum, mt), (ej, gj_sum, mj) = each(run)
    assert et == ej == 7.0 and float(mt) == float(mj) == 7.0
    same(gt_sum, gj_sum)
    assert d_of(gt_sum) == {int(base + 1): 1.0, int(base + 5): 12.0,
                            int(base + 9): 3.0, int(base + 100): 20.0,
                            int(dim - 1): 7.0}


def test_bfs_sparsevec_2p45():
    """BFS with a SparseVec frontier and a complemented SparseVec
    visited mask on a graph whose vertex ids live near 2^45: the bfs5m
    loop (vxm + SCMP/REPLACE + eWiseAdd) at hypersparse dimension."""
    dim = 1 << 45
    base = np.int64(77) << 33
    edges = [(0, 1), (1, 2), (2, 3), (1, 4)]

    def ids(k):
        return int(base + 10 * k)
    I = np.array([ids(a) for a, b in edges] + [ids(b) for a, b in edges],
                 np.int64)
    J = np.array([ids(b) for a, b in edges] + [ids(a) for a, b in edges],
                 np.int64)

    def run(pkg):
        t = pkg.FP64
        H = gt.HyperMatrix if pkg is gt else JHyper
        kw = {"device": CPU} if pkg is gt else {}
        A = H.from_coo(I, J, np.ones(len(I)), dim, dim, type=t, dup="MAX",
                       **kw)
        sr = pkg.Semiring(pkg.monoid.max[t], pkg.binary.times[t]) \
            if pkg is gb else gt.core.semirings.Semiring(
                gt.monoid.max[t], gt.binary.times[t])
        level = {ids(0): 1}
        frontier = sv(pkg, [ids(0)], np.array([1.0]), dim)
        visited, depth = frontier, 1
        while frontier.nvals:
            depth += 1
            nxt = pkg.vxm(sv(pkg, [], np.zeros(0), dim), visited, None, sr,
                          frontier, A,
                          pkg.Descriptor(mask_scmp=True, replace=True,
                                         mask_structure=True))
            for i in nxt.ids():
                level[int(i)] = depth
            visited = pkg.eWiseAdd(visited, None, None, pkg.binary.max[t],
                                   visited, nxt)
            frontier = nxt
        return level
    lt, lj = each(run)
    assert lt == lj == {ids(0): 1, ids(1): 2, ids(2): 3, ids(4): 3,
                        ids(3): 4}


def test_typed_error_on_matrix_operand():
    v = sv(gt, [1], [1.0], 10)
    M = gt.Matrix.new(gt.FP64, 3, 3, device=CPU)
    with pytest.raises(gt.UnsupportedContainer):
        gt.eWiseAdd(v, None, None, gt.binary.plus[gt.FP64], M, M)
    with pytest.raises(gt.UnsupportedContainer):
        gt.reduce_to_vector(v, None, None, gt.monoid.plus[gt.FP64], v)
