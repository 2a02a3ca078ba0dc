"""PyTorch port, the counting models through the GraphBLAS operations:
the tricount / ktruss / allktruss / kron parts of ``tests/test_models.py``
in parity with the JAX package.

``models.tricount``'s six methods run on the deterministic two-triangle
graph and on the symmetrized R-MAT scale 8 graph (edge factor 16, seed
7) as bitmap ``Matrix`` containers, against the JAX package's
``models.tricount`` and the port's ``tricount_esc``; ``ktruss`` /
``allktruss`` against the JAX package's and the port's ``ktruss_esc`` /
``allktruss_esc`` (bitmap and CSR containers); ``kron_generate``
against ``np.kron``, the JAX package's and ``kron``.  Every comparison
is exact."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import models as jmodels
from graphblas_tpu.models.rmat import rmat_edges as jax_rmat_edges
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import models


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU products: one intra-op thread a process keeps
    parallel test workers from oversubscribing the cores (the results
    do not depend on it); the setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _karate_like(pkg, **kw):
    edges = [(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (2, 4)]
    I = np.array([e[0] for e in edges] + [e[1] for e in edges])
    J = np.array([e[1] for e in edges] + [e[0] for e in edges])
    return pkg.Matrix.from_coo(I, J, np.ones(len(I), bool), 5, 5,
                               type=pkg.BOOL, dup=pkg.binary.lor[pkg.BOOL],
                               **kw)


def _rmat_both(scale):
    """The symmetrized R-MAT graph as a port and a JAX bitmap Matrix,
    plus the port's CSR of it."""
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    Ij, Jj = jax_rmat_edges(scale, 16, seed=7)
    assert np.array_equal(I, Ij) and np.array_equal(J, Jj)
    I, J = gt.symmetrize_pattern(I, J, n)
    X = np.ones(len(I), bool)
    At = gt.Matrix.from_coo(I, J, X, n, n, type=gt.BOOL, device="cpu")
    Aj = gb.Matrix.from_coo(I, J, X, n, n, type=gb.BOOL)
    Ac = gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.BOOL,
                               sum_duplicates=False, device="cpu")
    return At, Aj, Ac


def test_tricount_karate_like():
    A = _karate_like(gt, device="cpu")
    Aj = _karate_like(gb)
    L, U = models.tricount_prep(A)
    Lj, Uj = jmodels.tricount_prep(Aj)
    assert np.array_equal(L.pattern_np(), Lj.pattern_np())
    assert np.array_equal(U.pattern_np(), Uj.pattern_np())
    for m in range(6):
        assert models.tricount(m, A=A, E=None, L=L, U=U) == 2 == \
            jmodels.tricount(m, A=Aj, E=None, L=Lj, U=Uj)
    for name in models.METHODS:
        assert models.tricount(name, A=A, L=L, U=U) == 2


def test_edge_incidence_matches_jax():
    A = _karate_like(gt, device="cpu")
    E = models.edge_incidence(A)
    Ej = jmodels.edge_incidence(_karate_like(gb))
    assert E.type.name == Ej.type.name == "UINT32"
    assert np.array_equal(E.to_dense(), Ej.to_dense())
    assert np.array_equal(E.pattern_np(), Ej.pattern_np())


def test_tricount_rmat8_all_methods():
    At, Aj, Ac = _rmat_both(8)
    L, U = models.tricount_prep(At)
    Lj, Uj = jmodels.tricount_prep(Aj)
    E = models.edge_incidence(At)
    Ej = jmodels.edge_incidence(Aj)
    esc = gt.tricount_esc(gt.csr_tril(Ac, -1), gt.csr_triu(Ac, 1))
    assert esc > 0
    for m in range(6):
        got = models.tricount(m, A=At, E=E, L=L, U=U)
        assert got == esc == jmodels.tricount(m, A=Aj, E=Ej, L=Lj, U=Uj), \
            models.METHODS[m]


def test_tricount_on_csr_containers():
    """The models take CSR containers too: L, U and every product stay
    CSR, and the counts are the bitmap's."""
    At, _, Ac = _rmat_both(8)
    L, U = models.tricount_prep(Ac)
    assert isinstance(L, gt.CsrMatrix) and isinstance(U, gt.CsrMatrix)
    Lb, _ = models.tricount_prep(At)
    I, J, _ = L.extractTuples()
    Ib, Jb, _ = Lb.extractTuples()
    assert np.array_equal(I, Ib) and np.array_equal(J, Jb)
    want = models.tricount(5, L=Lb, U=models.tricount_prep(At)[1])
    for m in (1, 2, 3, 4, 5):
        assert models.tricount(m, A=Ac, L=L, U=U) == want


def _clique(k, n):
    I, J = [], []
    for i in range(k):
        for j in range(k):
            if i != j:
                I.append(i)
                J.append(j)
    for i in range(k - 1, n - 1):
        I += [i, i + 1]
        J += [i + 1, i]
    return np.array(I), np.array(J)


def test_ktruss_clique():
    I, J = _clique(5, 9)
    X = np.ones(len(I), bool)
    A = gt.Matrix.from_coo(I, J, X, 9, 9, type=gt.BOOL,
                           dup=gt.binary.lor[gt.BOOL], device="cpu")
    Aj = gb.Matrix.from_coo(I, J, X, 9, 9, type=gb.BOOL,
                            dup=gb.binary.lor[gb.BOOL])
    C, nsteps = models.ktruss(A, k=4)
    Cj, nj = jmodels.ktruss(Aj, k=4)
    pat = C.pattern_np()
    assert pat[:5, :5].sum() == 20 and pat[5:, :].sum() == 0
    assert nsteps == nj
    assert np.array_equal(pat, Cj.pattern_np())
    assert np.array_equal(C.to_dense(), Cj.to_dense())
    assert models.allktruss(A) == jmodels.allktruss(Aj)
    with pytest.raises(ValueError):
        models.ktruss(A, k=2)


@pytest.mark.parametrize("k", [3, 5])
def test_ktruss_rmat8_matches_jax_and_esc(k):
    At, Aj, Ac = _rmat_both(8)
    C, nsteps = models.ktruss(At, k)
    Cj, nj = jmodels.ktruss(Aj, k)
    assert nsteps == nj
    assert np.array_equal(C.pattern_np(), Cj.pattern_np())
    assert np.array_equal(C.to_dense(), Cj.to_dense())
    truss, sup, esc_steps = gt.ktruss_esc(Ac, k)
    Cs, ns = models.ktruss(Ac, k)
    assert isinstance(Cs, gt.CsrMatrix)
    I, J, X = Cs.extractTuples()
    It, Jt, _ = truss.extractTuples()
    assert np.array_equal(I, It) and np.array_equal(J, Jt)
    assert np.array_equal(X, sup[:truss.nvals].numpy().astype(np.int64))
    Ib, Jb, Xb = C.extractTuples()
    assert np.array_equal(I, Ib) and np.array_equal(X, Xb)
    assert ns == nsteps


def test_allktruss_rmat8_matches_jax_and_esc():
    At, Aj, Ac = _rmat_both(8)
    got = models.allktruss(At)
    assert got == jmodels.allktruss(Aj)
    assert got == models.allktruss(Ac)
    # the sweep counts may differ where the truss vanishes (each loop
    # stops on its own test); edges and triangles per k may not
    esc = gt.allktruss_esc(Ac)

    def edges_tris(out):
        return {k: (v["nedges"], v["nt"]) for k, v in out.items()}
    assert edges_tris(got) == edges_tris(esc)


def test_kron_generate_matches_dense_and_jax():
    rng = np.random.default_rng(5)
    Ad = rng.random((4, 3)) * (rng.random((4, 3)) < 0.6)
    Bd = rng.random((3, 5)) * (rng.random((3, 5)) < 0.6)
    A = gt.Matrix.from_dense(Ad, gt.FP64, pattern=Ad != 0, device="cpu")
    B = gt.Matrix.from_dense(Bd, gt.FP64, pattern=Bd != 0, device="cpu")
    Aj = gb.Matrix.from_dense(Ad, gb.FP64, pattern=Ad != 0)
    Bj = gb.Matrix.from_dense(Bd, gb.FP64, pattern=Bd != 0)
    want = np.kron(Ad, Bd)
    for nshards in (1, 3):
        C = models.kron_generate(A, B, nshards=nshards)
        Cj = jmodels.kron_generate(Aj, Bj, nshards=nshards)
        assert np.allclose(C.to_dense(), want)
        assert np.array_equal(C.to_dense(), Cj.to_dense())
        assert np.array_equal(C.pattern_np(), Cj.pattern_np())
    C = models.kron_generate(A, B, op=gt.binary.plus[gt.FP64])
    Cj = jmodels.kron_generate(Aj, Bj, op=gb.binary.plus[gb.FP64])
    assert np.array_equal(C.to_dense(), Cj.to_dense())


def test_kron_matches_gxb_kron():
    rng = np.random.default_rng(6)
    Ad = (rng.random((3, 3)) < 0.5) * rng.random((3, 3))
    Bd = (rng.random((4, 4)) < 0.5) * rng.random((4, 4))
    A = gt.Matrix.from_dense(Ad, gt.FP64, pattern=Ad != 0, device="cpu")
    B = gt.Matrix.from_dense(Bd, gt.FP64, pattern=Bd != 0, device="cpu")
    C1 = models.kron_generate(A, B)
    C2 = gt.kron(gt.Matrix.new(gt.FP64, 12, 12, device="cpu"), None, None,
                 gt.binary.times[gt.FP64], A, B)
    assert np.array_equal(C1.to_dense(), C2.to_dense())
    assert torch.equal(C1.pattern, C2.pattern)
