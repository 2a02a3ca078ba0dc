"""PyTorch port, the graph models (``models/bfs.py``, ``models/mis.py``,
``models/pagerank.py``) and the generators (``models/generate.py``,
``rmat_graph``): parity with the JAX package.

Mirrors the BFS, MIS, PageRank and generator parts of
``tests/test_models.py``.  The reference's matrix corpus is not in the
repository, so the graphs are generated: the symmetrized R-MAT graph
(edge factor 16, seed 7) at scales 8-10, ``random_matrix`` and Wathen
nx = ny = 4-8, each made from its seed and run through the JAX
package's function (on the CPU) and the port's.  BFS levels, the MIS
set (its random stream is the reference's ``simple_rand``, drawn in the
same order), ``ipagerank``'s integer ranks and the generated matrices
must be equal exactly; ``dpagerank``'s values within rtol 1e-12 (the
same float64 operations, summed in another order)."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import models as jm
from graphblas_tpu.models.pagerank import _crand_stream as jax_crand
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import models as tm
from graphblas_tpu_torch.convert import from_jax
from graphblas_tpu_torch.models.pagerank import _crand_stream

from .test_models import bfs_levels_oracle, pagerank_oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU products: one intra-op thread a process keeps
    parallel test workers from oversubscribing the cores (the results
    do not depend on it); the setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rmat(scale):
    """The symmetrized R-MAT graph's (I, J, n)."""
    n = 1 << scale
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(scale, 16, seed=7), n)
    return I, J, n


def graph(kind, I, J, n, X=None):
    """(port, JAX) BOOL adjacency as a CSR or bitmap container."""
    X = np.ones(len(I), bool) if X is None else X
    if kind == "csr":
        return (gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.BOOL,
                                      sum_duplicates=False, device="cpu"),
                JCsr.from_coo(I, J, X, n, n, type=gb.BOOL,
                              sum_duplicates=False))
    return (gt.Matrix.from_coo(I, J, X, n, n, type=gt.BOOL, device="cpu"),
            gb.Matrix.from_coo(I, J, X, n, n, type=gb.BOOL))


def same_vector(vt, vj):
    assert vt.type.name == vj.type.name
    for x, y in zip(vt.extractTuples(), vj.extractTuples()):
        assert np.array_equal(x, np.asarray(y))


def _random_graph(seed=7):
    """A symmetric boolean ``random_matrix`` graph without self edges,
    as (I, J, n)."""
    A = gt.models.random_matrix(120, 120, 400, make_symmetric=True,
                                no_self_edges=True, boolean=True,
                                seed=seed, device="cpu")
    I, J, _ = A.extractTuples()
    return I, J, 120


def _wathen_graph(nx):
    Ap = tm.wathen_pattern(nx, nx)
    np.fill_diagonal(Ap, False)
    I, J = np.nonzero(Ap)
    return I, J, Ap.shape[0]


GRAPHS = {"rmat8": lambda: rmat(8), "rmat10": lambda: rmat(10),
          "random": _random_graph, "wathen4": lambda: _wathen_graph(4)}


@pytest.mark.parametrize("kind", ["csr", "bitmap"])
@pytest.mark.parametrize("name", ["rmat8", "rmat10", "random", "wathen4"])
def test_bfs_variants_match_jax(name, kind):
    I, J, n = GRAPHS[name]()
    At, Aj = graph(kind, I, J, n)
    Ap = np.zeros((n, n), bool)
    Ap[I, J] = True
    want = bfs_levels_oracle(Ap, 0)
    # the checked variants and ``bfs`` are the same functions, as there
    assert tm.bfs5m_check is tm.bfs5m and tm.bfs is tm.bfs5m
    assert tm.bfs6_check is tm.bfs6
    for fn in ("bfs5m", "bfs6"):
        vt, vj = getattr(tm, fn)(At, 0), getattr(jm, fn)(Aj, 0)
        same_vector(vt, vj)
        got = np.where(vt.pattern_np(), vt.to_dense(), 0).astype(np.int64)
        assert (got == want).all(), fn
    if kind == "csr":
        assert np.array_equal(gt.bfs_csr(At, 0), want)
    else:
        lev = tm.bfs_jit(At, 0)
        assert lev.dtype == np.int32
        assert np.array_equal(lev, jm.bfs_jit(Aj, 0))
        assert np.array_equal(lev, want)


def test_bfs_level_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 4, 9).astype(np.int32)
    vp, q, qp = rng.random(9) < 0.5, rng.random(9) < 0.5, rng.random(9) < 0.6
    vt = gt.Vector.from_dense(v, gt.INT32, pattern=vp, device="cpu")
    qt = gt.Vector.from_dense(q, gt.BOOL, pattern=qp, device="cpu")
    vj = gb.Vector.from_dense(v, gb.INT32, pattern=vp)
    qj = gb.Vector.from_dense(q, gb.BOOL, pattern=qp)
    same_vector(tm.bfs_level(vt, qt, 5), jm.bfs_level(vj, qj, 5))


@pytest.mark.parametrize("kind", ["csr", "bitmap"])
@pytest.mark.parametrize("name,seed", [("rmat8", 42), ("rmat10", 42),
                                       ("random", 1), ("wathen4", 3)])
def test_mis_matches_jax(name, seed, kind):
    """The same set as the JAX package's, member for member: the scores'
    random stream matches bit for bit."""
    I, J, n = GRAPHS[name]()
    At, Aj = graph(kind, I, J, n)
    st, sj = tm.mis(At, seed=seed), jm.mis(Aj, seed=seed)
    same_vector(st, sj)
    assert tm.mis_check(At, st)
    assert jm.mis_check(gb.Matrix.from_coo(I, J, np.ones(len(I), bool), n,
                                           n, type=gb.BOOL), sj)


def test_mis_isolated_vertices_and_check():
    """Singletons join the set up front; ``mis_check`` rejects a set that
    is not independent, or not maximal, and ignores explicit false
    edges (valued adjacency)."""
    I = np.array([0, 1, 1, 2, 4, 5])
    J = np.array([1, 0, 2, 1, 5, 4])
    X = np.array([True, True, True, True, False, False])
    At, Aj = graph("csr", I, J, 7, X)
    st, sj = tm.mis(At, seed=5), jm.mis(Aj, seed=5)
    same_vector(st, sj)
    members = set(st.extractTuples()[0].tolist())
    assert {3, 4, 5, 6} <= members and tm.mis_check(At, st)
    bad = gt.Vector.from_coo([0, 1, 3, 4, 5, 6], [True] * 6, 7, type=gt.BOOL,
                             device="cpu")
    assert not tm.mis_check(At, bad)
    lazy = gt.Vector.from_coo([3, 4, 5, 6], [True] * 4, 7, type=gt.BOOL,
                              device="cpu")
    assert not tm.mis_check(At, lazy)


def _rank_dict(ranks):
    return {p: v for p, v in ranks}


@pytest.mark.parametrize("name", ["rmat8", "random", "wathen8"])
def test_dpagerank_ipagerank_match_jax(name):
    if name == "wathen8":
        # the FP64-valued Wathen matrix itself: row sums of its values
        At = tm.wathen(8, 8, device="cpu")
        Aj = jm.wathen(8, 8)
        n = At.nrows
        Ap = At.pattern_np()
    else:
        I, J, n = GRAPHS[name]()
        At, Aj = graph("bitmap", I, J, n)
        Ap = At.pattern_np()
    dt, dj = tm.dpagerank(At), jm.dpagerank(Aj)
    a, b = _rank_dict(dt), _rank_dict(dj)
    assert a.keys() == b.keys()
    keys = sorted(a)
    assert np.allclose([a[k] for k in keys], [b[k] for k in keys],
                       rtol=1e-12, atol=0)
    vals = [v for _, v in dt]
    assert vals == sorted(vals, reverse=True)
    if name != "wathen8":
        r0 = _crand_stream(n, n).astype(np.float64) / 2147483647.0
        want = pagerank_oracle(Ap, n, r0=r0)
        got = np.zeros(n)
        for p, v in dt:
            got[p] = v
        assert np.allclose(got, want, rtol=1e-12)
    it, ij = tm.ipagerank(At), jm.ipagerank(Aj)
    assert it == ij
    assert all(isinstance(v, int) for _, v in it)


def test_pagerank_seed_and_rowscale_match_jax():
    I, J, n = rmat(8)
    At, Aj = graph("bitmap", I, J, n)
    a = _rank_dict(tm.dpagerank(At, iters=3, seed=11))
    b = _rank_dict(jm.dpagerank(Aj, iters=3, seed=11))
    assert a.keys() == b.keys()
    assert np.allclose([a[k] for k in sorted(a)], [b[k] for k in sorted(a)],
                       rtol=1e-12, atol=0)
    assert tm.ipagerank(At, iters=4, seed=11) == jm.ipagerank(Aj, iters=4,
                                                              seed=11)
    for ft, fj in ((tm.drowscale, jm.drowscale),
                   (tm.irowscale, jm.irowscale)):
        Ct, Cj = ft(At), fj(Aj)
        assert Ct.type.name == Cj.type.name
        assert np.array_equal(Ct.pattern_np(), np.asarray(Cj.pattern))
        assert np.array_equal(Ct.to_dense(), np.asarray(Cj.to_dense()))
    assert np.array_equal(_crand_stream(500, 77), jax_crand(500, 77))


def test_pagerank_jit_matches_jax():
    rng = np.random.default_rng(3)
    Ap = rng.random((40, 40)) < 0.2
    np.fill_diagonal(Ap, False)
    At = gt.Matrix.from_dense(Ap.astype(np.float64), gt.FP64, pattern=Ap,
                              device="cpu")
    Aj = gb.Matrix.from_dense(Ap.astype(np.float64), gb.FP64, pattern=Ap)
    rt, rj = tm.pagerank_jit(At, iters=50), jm.pagerank_jit(Aj, iters=50)
    assert np.allclose(rt, rj, rtol=1e-12, atol=0)
    deg = Ap.sum(axis=1).astype(float)
    C = np.where(Ap, 1.0 / np.where(deg == 0, 1, deg)[:, None], 0.0)
    r2 = 0.85 * (rt @ C) + (0.15 / 40) * rt.sum()
    assert np.allclose(rt, r2 / r2.sum(), atol=1e-6)


def test_pagerank_takes_a_bitmap_matrix():
    """The row scaling reads A's dense pattern, as the JAX package's:
    a CsrMatrix raises, for the UDT PageRank on the bitmap container
    too; its CSR form takes the CsrMatrix (tests/test_torch_udt.py
    holds both against the JAX package)."""
    I, J, n = rmat(8)
    At, _ = graph("csr", I, J, n)
    for fn in (tm.dpagerank, tm.ipagerank, tm.drowscale, tm.pagerank_jit,
               tm.dpagerank2):
        with pytest.raises(gt.UnsupportedContainer, match="bitmap Matrix"):
            fn(At)
    ranks, iters = tm.dpagerank2_csr(At)
    assert iters > 0 and abs(sum(r for _, r in ranks) - 1.0) < 1e-12


@pytest.mark.parametrize("nx", [4, 6])
def test_wathen_generators_match_jax(nx):
    At, Aj = tm.wathen(nx, nx, device="cpu"), jm.wathen(nx, nx)
    assert np.array_equal(At.pattern_np(), np.asarray(Aj.pattern))
    assert np.array_equal(At.to_dense(), np.asarray(Aj.to_dense()))
    assert np.array_equal(tm.wathen_pattern(nx, nx), jm.wathen_pattern(nx, nx))
    if nx == 4:
        assert At.nvals() == 817      # tri_demo.out "nz 817" for nx=ny=4
        Ad = At.to_dense()
        assert np.allclose(Ad, Ad.T)
    rho = np.ones((2, 2))
    Bt, Bj = tm.wathen(2, 2, rho=rho, device="cpu"), jm.wathen(2, 2, rho=rho)
    assert np.array_equal(Bt.to_dense(), np.asarray(Bj.to_dense()))
    with pytest.raises(ValueError):
        tm.wathen(2, 2, method=4, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"make_symmetric": True},
                                {"no_self_edges": True, "boolean": True}])
def test_random_matrix_matches_jax(kw):
    shape = (50, 50) if kw.get("make_symmetric") else (50, 40)
    At = tm.random_matrix(*shape, 200, seed=7, device="cpu", **kw)
    Aj = jm.random_matrix(*shape, 200, seed=7, **kw)
    assert At.type.name == Aj.type.name
    assert np.array_equal(At.pattern_np(), np.asarray(Aj.pattern))
    assert np.array_equal(At.to_dense(), np.asarray(Aj.to_dense()))
    assert 0 < At.nvals() <= 200 * (2 if kw.get("make_symmetric") else 1)


def test_rmat_graph_matches_jax():
    from graphblas_tpu.models.rmat import rmat_graph as jax_rmat_graph
    At, Aj = tm.rmat_graph(8, 4, seed=5, device="cpu"), jax_rmat_graph(8, 4,
                                                                       seed=5)
    assert At.nrows == 256 and At.type.name == Aj.type.name == "FP32"
    assert At.nvals == Aj.nvals == len(gt.rmat_edges(8, 4, seed=5)[0])
    for x, y in zip(At.extractTuples(), Aj.extractTuples()):
        assert np.array_equal(x, np.asarray(y))
    Bt = from_jax(Aj, device="cpu")
    assert torch.equal(Bt.indptr, At.indptr)


def test_entry_points_need_a_device(monkeypatch):
    """The generators build on the card unless the caller names a
    device: with no card they raise rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: tm.wathen(2, 2), lambda: tm.rmat_graph(4, 2),
               lambda: tm.random_matrix(5, 5, 4),
               lambda: gt.pack_rows(np.ones((2, 3), bool))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
