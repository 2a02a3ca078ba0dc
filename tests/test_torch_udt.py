"""PyTorch port, user-defined struct types: parity with the JAX package.

Mirrors ``tests/test_udt_csr.py`` (all five tests), ``test_nested_udt``,
``test_from_coo_udt_raises`` and the struct ``to_dense(fill)`` case of
``tests/test_api.py``, and ``test_udt_setelement_csr`` of
``tests/test_pending_sparse.py``; the same seeded numpy inputs go
through both packages.  Integer fields, patterns and iteration counts
are exact; FP64 fields agree within rtol 1e-12.  A struct op that needs
a ``where`` is written once per package; the others once, with
operators both ``jnp`` arrays and tensors take.  Also: ``convert.
from_jax`` of struct containers (pending tuples included) and the leaf
order of :mod:`graphblas_tpu_torch.utils.tree`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.core.matrix import Matrix as JMatrix
from graphblas_tpu.core.monoids import monoid_new as jmonoid_new
from graphblas_tpu.core.ops import BinaryOp as JBinaryOp
from graphblas_tpu.core.semirings import semiring_new as jsemiring_new
from graphblas_tpu.core.types import Type as JType
from graphblas_tpu.models.pagerank import dpagerank2 as jdpagerank2
from graphblas_tpu.models.pagerank import dpagerank2_csr as jdpagerank2_csr
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
from graphblas_tpu.sparse.spmv import csr_mxv as jcsr_mxv
from graphblas_tpu.sparse.spmv import segment_reduce_sorted as jsrs
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.convert import (from_jax, hyper_from_arrays,
                                         type_from_jax)
from graphblas_tpu_torch.sparse.spmv import csr_mxv as tcsr_mxv
from graphblas_tpu_torch.sparse.spmv import segment_reduce_sorted as tsrs
from graphblas_tpu_torch.utils import tree

CPU = "cpu"
JPOINT = JType.udt("point", x=gb.FP64, y=gb.FP64)
TPOINT = gt.Type.udt("point", x=gt.FP64, y=gt.FP64)


def _coo(rng, n, nnz):
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    _, keep = np.unique(I * n + J, return_index=True)
    return I[keep], J[keep]


def _same_tuples(got, want, fields=("x", "y")):
    Ig, Jg, Xg = got
    Iw, Jw, Xw = want
    assert np.array_equal(Ig, Iw) and np.array_equal(Jg, Jw)
    for f in fields:
        np.testing.assert_allclose(Xg[f], np.asarray(Xw[f]), rtol=1e-12)


def test_udt_csr_roundtrip():
    rng = np.random.default_rng(42)
    n = 20
    I, J = _coo(rng, n, 40)
    X = {"x": rng.random(len(I)), "y": rng.random(len(I))}
    Aj = JCsr.from_coo(I, J, X, n, n, type=JPOINT, sum_duplicates=False)
    At = gt.CsrMatrix.from_coo(I, J, X, n, n, type=TPOINT,
                               sum_duplicates=False, device=CPU)
    _same_tuples(At.extractTuples(), Aj.extractTuples())
    Bt = gt.CsrMatrix.from_matrix(At.to_matrix())
    _same_tuples(Bt.extractTuples(), JCsr.from_matrix(
        Aj.to_matrix()).extractTuples())
    _same_tuples(At.T().extractTuples(), Aj.T().extractTuples())
    # every leaf in its field's storage, on the container's device
    assert At.values["x"].dtype == torch.float64
    assert At.values["y"].device.type == CPU


def test_udt_duplicate_rejected():
    I, J = np.array([1, 1]), np.array([2, 2])
    X = {"x": np.ones(2), "y": np.ones(2)}
    with pytest.raises(TypeError):
        JCsr.from_coo(I, J, X, 4, 4, type=JPOINT)
    with pytest.raises(TypeError):
        gt.CsrMatrix.from_coo(I, J, X, 4, 4, type=TPOINT, device=CPU)
    with pytest.raises(TypeError):
        gt.hyper_from_coo(I, J, X, 4, 4, type=TPOINT, device=CPU)


def _padd(t):
    cls = JBinaryOp if isinstance(t, JType) else gt.BinaryOp
    return cls("PADD", lambda a, b: {"x": a["x"] + b["x"],
                                     "y": a["y"] * b["y"]}, t, t, t)


def test_segment_reduce_sorted_udt():
    seg = np.array([0, 0, 2, 2, 2, 5], np.int32)
    vals = {"x": np.arange(6, dtype=np.float64),
            "y": np.arange(1, 7, dtype=np.float64)}
    want = jsrs(_padd(JPOINT), {"x": 0.0, "y": 1.0},
                {k: jnp.asarray(v) for k, v in vals.items()},
                jnp.asarray(seg), 6)
    got = tsrs(_padd(TPOINT), {"x": 0.0, "y": 1.0},
               {k: torch.from_numpy(v) for k, v in vals.items()},
               torch.from_numpy(seg), 6)
    for f, exp in (("x", [1, 0, 9, 0, 0, 5]), ("y", [2, 1, 60, 1, 1, 6])):
        assert np.allclose(np.asarray(want[f]), exp)
        assert np.array_equal(got[f].numpy(), np.asarray(want[f]))


def test_udt_csr_mxv_matches_manual():
    """The struct SpMV of both packages against a dense computation."""
    rng = np.random.default_rng(42)
    n, nnz = 30, 90
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    x = {"x": rng.random(n), "y": rng.random(n)}
    Aj = JCsr.from_coo(I, J, np.ones(nnz, bool), n, n, type=gb.BOOL)
    At = gt.CsrMatrix.from_coo(I, J, np.ones(nnz, bool), n, n, type=gt.BOOL,
                               device=CPU)
    jmult = JBinaryOp("PMUL", lambda a, xx: {
        "x": jnp.where(jnp.asarray(a, bool), xx["x"], 0.0),
        "y": jnp.zeros_like(xx["y"])}, JPOINT, gb.BOOL, JPOINT)
    tmult = gt.BinaryOp("PMUL", lambda a, xx: {
        "x": torch.where(a.to(torch.bool), xx["x"], 0.0),
        "y": torch.zeros_like(xx["y"])}, TPOINT, gt.BOOL, TPOINT)

    def add(t):
        cls = JBinaryOp if t is JPOINT else gt.BinaryOp
        return cls("PADD", lambda a, b: {"x": a["x"] + b["x"],
                                         "y": a["y"] + b["y"]}, t, t, t)
    jsr = jsemiring_new(jmonoid_new(add(JPOINT), {"x": 0.0, "y": 0.0}),
                        jmult)
    tsr = gt.semiring_new(gt.monoid_new(add(TPOINT), {"x": 0.0, "y": 0.0}),
                          tmult)
    yj, pj = jcsr_mxv(jsr, Aj, {k: jnp.asarray(v) for k, v in x.items()})
    yt, pt = tcsr_mxv(tsr, At, {k: torch.from_numpy(v)
                                for k, v in x.items()})
    D = np.zeros((n, n))
    D[I, J] = 1.0
    rows = D.sum(axis=1) > 0
    assert np.array_equal(pt.numpy(), rows)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(yt["x"].numpy()[rows], (D @ x["x"])[rows],
                               rtol=1e-12)
    np.testing.assert_allclose(yt["x"].numpy(), np.asarray(yj["x"]),
                               rtol=1e-12)
    assert np.allclose(yt["x"].numpy()[~rows], 0.0)
    assert gt.last_axb_method() == "spmv:udt"


def _graph(rng, n, nedges):
    i = rng.integers(0, n, nedges)
    j = rng.integers(0, n, nedges)
    keep = i != j
    lin = np.unique(i[keep] * n + j[keep])
    return lin // n, lin % n


def _ranks_close(got, want):
    g, w = dict(got), dict(want)
    assert set(g) == set(w)
    for p in w:
        assert abs(g[p] - w[p]) <= 1e-12 * abs(w[p]) + 1e-15


def test_dpagerank2_csr_matches_bitmap():
    """The UDT PageRank: the port's CSR and bitmap models against each
    other and against the JAX package's two (same iterations, ranks
    within rtol 1e-12)."""
    rng = np.random.default_rng(42)
    n = 60
    I, J = _graph(rng, n, 300)
    X = np.ones(len(I), bool)
    want, it_w = jdpagerank2(JMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                              dup=None), itermax=50)
    want_c, it_wc = jdpagerank2_csr(JCsr.from_coo(
        I, J, X, n, n, type=gb.BOOL, sum_duplicates=False), itermax=50)
    got, it_g = gt.models.dpagerank2(gt.Matrix.from_coo(
        I, J, X, n, n, type=gt.BOOL, device=CPU), itermax=50)
    got_c, it_gc = gt.models.dpagerank2_csr(gt.CsrMatrix.from_coo(
        I, J, X, n, n, type=gt.BOOL, sum_duplicates=False, device=CPU),
        itermax=50)
    assert it_w == it_wc == it_g == it_gc
    _ranks_close(got, want)
    _ranks_close(got_c, want_c)
    _ranks_close(got_c, got)


def test_pagerank_type_matches_jax():
    from graphblas_tpu.models.pagerank import PAGERANK_TYPE as JPR
    tpr = gt.models.PAGERANK_TYPE
    assert tpr.name == JPR.name
    assert [k for k, _ in tpr.fields] == [k for k, _ in JPR.fields]
    mult, add, mon, sr = gt.models.pagerank_ops()
    assert sr.ztype is tpr and mon.identity == {"rank": 0.0,
                                                "invdegree": 0.0}


def test_nested_udt():
    jin = JType.udt("inner", a=gb.FP64, b=gb.FP32)
    jout = JType.udt("outer", x=jin, y=gb.INT32)
    tin = gt.Type.udt("inner", a=gt.FP64, b=gt.FP32)
    tout = gt.Type.udt("outer", x=tin, y=gt.INT32)
    v = {"x": {"a": 1.5, "b": 2.5}, "y": 7}
    Mj = gb.Matrix.new(jout, 2, 2).setElement(v, 0, 1)
    Mt = gt.Matrix.new(tout, 2, 2, device=CPU).setElement(v, 0, 1)
    gj, g = Mj.extractElement(0, 1), Mt.extractElement(0, 1)
    assert g["x"]["a"] == gj["x"]["a"] == 1.5
    assert g["x"]["b"] == gj["x"]["b"] == 2.5
    assert g["y"] == gj["y"] == 7
    assert Mt.nvals() == Mj.nvals() == 1
    assert Mt.values["x"]["b"].dtype == torch.float32
    assert Mt.extractElement(1, 1) is None
    # the nested struct through CSR and back
    C = gt.CsrMatrix.from_matrix(Mt)
    assert C.extractElement(0, 1)["x"]["a"] == 1.5


def test_from_coo_udt_raises():
    ju = JType.udt("u2", a=gb.FP64)
    tu = gt.Type.udt("u2", a=gt.FP64)
    with pytest.raises(TypeError):
        gb.Matrix.from_coo([0], [0], [{"a": 1.0}], 2, 2, type=ju)
    with pytest.raises(TypeError):
        gt.Matrix.from_coo([0], [0], [{"a": 1.0}], 2, 2, type=tu,
                           device=CPU)
    with pytest.raises(TypeError):
        gt.Vector.from_coo([0], [{"a": 1.0}], 2, type=tu, device=CPU)


def test_udt_to_dense_fill():
    ju = JType.udt("tdr", a=gb.FP64)
    tu = gt.Type.udt("tdr", a=gt.FP64)
    want = gb.Matrix.new(ju, 2, 2).setElement({"a": 3.0}, 0, 0).to_dense(
        fill=-1.0)
    got = gt.Matrix.new(tu, 2, 2, device=CPU).setElement(
        {"a": 3.0}, 0, 0).to_dense(fill=-1.0)
    assert got["a"][0][0] == 3.0 and got["a"][1][1] == -1.0
    assert np.array_equal(got["a"], np.asarray(want["a"]))


def test_udt_setelement_csr():
    """Struct values through the CSR pending path, as the JAX package's
    ``test_udt_setelement_csr``."""
    X = {"a": np.array([1.5]), "b": np.array([2], np.int32)}
    jt = gb.Type.udt("pair2", a=gb.FP64, b=gb.INT32)
    tt = gt.Type.udt("pair2", a=gt.FP64, b=gt.INT32)
    Aj = JCsr.from_coo(np.array([0]), np.array([1]), X, 3, 3, type=jt)
    At = gt.CsrMatrix.from_coo(np.array([0]), np.array([1]), X, 3, 3,
                               type=tt, device=CPU)
    Aj = Aj.setElement({"a": 4.5, "b": 7}, 2, 2)
    At = At.setElement({"a": 4.5, "b": 7}, 2, 2)
    assert len(At._pending) == 1
    got, want = At.extractElement(2, 2), Aj.extractElement(2, 2)
    assert got["a"] == want["a"] == 4.5 and got["b"] == want["b"] == 7
    assert At.extractElement(0, 1)["a"] == 1.5
    _same_tuples(At.extractTuples(), Aj.wait().extractTuples(),
                 fields=("a", "b"))


def test_udt_setelement_accum_runs_match_jax():
    """Runs of struct tuples with and without an accum, duplicates
    included, fold as the JAX package folds them (on CSR; the port's
    hypersparse fold agrees)."""
    rng = np.random.default_rng(7)
    n = 12
    jt = gb.Type.udt("pair2", a=gb.FP64, b=gb.INT32)
    tt = gt.Type.udt("pair2", a=gt.FP64, b=gt.INT32)

    def acc(cls, t):
        return cls("PACC", lambda x, y: {"a": x["a"] + y["a"],
                                         "b": x["b"] * y["b"]}, t, t, t)
    jacc, tacc = acc(JBinaryOp, jt), acc(gt.BinaryOp, tt)
    I, J = _coo(rng, n, 20)
    X = {"a": rng.random(len(I)), "b": rng.integers(1, 4, len(I),
                                                    dtype=np.int32)}
    Aj = JCsr.from_coo(I, J, X, n, n, type=jt)
    At = gt.CsrMatrix.from_coo(I, J, X, n, n, type=tt, device=CPU)
    Ht = gt.hyper_from_coo(I, J, X, n, n, type=tt, device=CPU)
    for k in range(60):
        i, j = int(rng.integers(0, n)), int(rng.integers(0, n))
        v = {"a": float(rng.random()), "b": int(rng.integers(1, 4))}
        use = (k // 10) % 2 == 1
        Aj = Aj.setElement(v, i, j, accum=jacc if use else None)
        At = At.setElement(v, i, j, accum=tacc if use else None)
        Ht = Ht.setElement(v, i, j, accum=tacc if use else None)
    want = Aj.wait().extractTuples()
    _same_tuples(At.wait().extractTuples(), want, fields=("a", "b"))
    _same_tuples(Ht.wait().extractTuples(), want, fields=("a", "b"))


def test_from_jax_carries_udt_containers():
    """``from_jax`` carries a struct type (same name, fields
    recursively) and its dict values leaf by leaf on CSR, CSC, bitmap
    and the hypersparse containers, pending tuples included; a JAX
    user op is not carried."""
    rng = np.random.default_rng(3)
    n = 9
    I, J = _coo(rng, n, 15)
    X = {"x": rng.random(len(I)), "y": rng.random(len(I))}
    Aj = JCsr.from_coo(I, J, X, n, n, type=JPOINT)
    Aj = Aj.setElement({"x": 2.0, "y": 3.0}, 0, 0)
    At = from_jax(Aj, device=CPU)
    assert At.type == TPOINT and len(At._pending) == 1
    _same_tuples(At.wait().extractTuples(), Aj.wait().extractTuples())
    Cj = gb.sparse.CscMatrix.from_coo(I, J, X, n, n, type=JPOINT)
    _same_tuples(from_jax(Cj, device=CPU).extractTuples(),
                 Cj.extractTuples())
    Mj = Aj.wait().to_matrix()
    Mt = from_jax(Mj, device=CPU)
    for f in ("x", "y"):
        assert np.array_equal(Mt.to_dense()[f], np.asarray(
            Mj.to_dense()[f]))
    # the JAX hypersparse container holds no struct values (its build
    # folds tuples with numpy); the arrays path from_jax takes for one
    # carries them leaf by leaf
    Ht = gt.HyperMatrix.from_csr(At.wait())
    H2 = hyper_from_arrays(
        Ht.h.numpy(), Ht.hptr.numpy(), Ht.rowids.numpy(),
        Ht.indices.numpy(), {k: v.numpy() for k, v in Ht.values.items()},
        Ht.nvals, Ht.nvec, n, n, type_from_jax(JPOINT), device=CPU)
    _same_tuples(H2.extractTuples(), Aj.wait().extractTuples())
    Vj = gb.Vector.new(JPOINT, 4).setElement({"x": 1.0, "y": 2.0}, 3)
    Vt = from_jax(Vj, device=CPU)
    assert Vt.extractElement(3) == {"x": 1.0, "y": 2.0}
    bad = Aj.setElement({"x": 1.0, "y": 1.0}, 1, 1,
                        accum=_padd(JPOINT))
    with pytest.raises(TypeError, match="not carried"):
        from_jax(bad, device=CPU)


def test_tree_leaf_order_is_jax_order():
    """Leaves come in sorted-key order, as ``jax.tree_util`` orders a
    dict, whatever the insertion order."""
    t = {"y": {"b": 1, "a": 2}, "x": 3}
    assert tree.tree_leaves(t) == jax.tree_util.tree_leaves(t)
    leaves, s = tree.tree_flatten(t)
    assert tree.tree_unflatten(s, [v * 10 for v in leaves]) == \
        {"x": 30, "y": {"a": 20, "b": 10}}
    assert tree.tree_map(lambda a, b: a + b, t, t) == \
        {"x": 6, "y": {"a": 4, "b": 2}}
