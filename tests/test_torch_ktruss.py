"""PyTorch port, k-truss and the edge-centric bitpacked counts
(sparse/tri.py ktruss_esc / allktruss_esc, sparse/bitdot.py liveness
re-packing, sparse/spgemm.py): parity with the JAX package.

Graphs are made with numpy from a seed and go through both packages on
the CPU, where the port's popcount wrapper runs the kernel's plain
version.  Every quantity is an integer: truss patterns, supports, sweep
counts and plan arrays must be exactly equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import models as jmodels
from graphblas_tpu import sparse as jsp
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.sparse import tri as jtri
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import bitdot as tbd
from graphblas_tpu_torch.sparse import tri as ttri

CPU = "cpu"


def _sym_graph(seed, n, nedges):
    """The JAX tri test's random symmetric loopless graph (deduped)."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, nedges)
    j = rng.integers(0, n, nedges)
    keep = i != j
    lin = np.unique(np.concatenate([i[keep] * n + j[keep],
                                    j[keep] * n + i[keep]]))
    return lin // n, lin % n


def _powerlaw(seed, n=400, alpha=1.2, mult=3):
    """The JAX bitdot test's power-law graph (symmetric, deduped)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(alpha, n) * mult).astype(int) + 1, n - 1)
    I = np.repeat(np.arange(n), deg)
    J = rng.integers(0, n, size=len(I))
    keep = I != J
    lin = np.unique(np.concatenate([I[keep] * n + J[keep],
                                    J[keep] * n + I[keep]]))
    return lin // n, lin % n


def _csr_both(I, J, n, tname="BOOL"):
    X = np.ones(len(I), bool if tname == "BOOL" else np.uint32)
    return (gt.csr_from_coo(I, J, X, n, n, type=getattr(gt, tname),
                            sum_duplicates=False, device=CPU),
            jsp.CsrMatrix.from_coo(I, J, X, n, n, type=getattr(gb, tname),
                                   sum_duplicates=False))


def _bitmap_both(I, J, n):
    X = np.ones(len(I), bool)
    return (gt.Matrix.from_coo(I, J, X, n, n, type=gt.BOOL, device=CPU),
            gb.Matrix.from_coo(I, J, X, n, n, type=gb.BOOL))


def _same_truss(got, want):
    """(truss, supports, nsteps) of both packages: the same entries in
    the same padded order, the same supports over them."""
    (tt, ct, st), (tj, cj, sj) = got, want
    assert tt.nvals == tj.nvals and st == sj
    It, Jt, _ = tt.extractTuples()
    Ij, Jj, _ = tj.extractTuples()
    assert np.array_equal(It, np.asarray(Ij))
    assert np.array_equal(Jt, np.asarray(Jj))
    assert ct.dtype == torch.int32 and ct.shape[0] == tt.nzmax
    assert np.array_equal(ct[:tt.nvals].numpy(),
                          np.asarray(cj)[:tj.nvals])


@pytest.fixture
def bitmaps_pay(monkeypatch):
    """At these sizes the planner would leave every wedge to the
    sort-merge; let the bitmap panels take the heavy columns in both."""
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)


@pytest.fixture
def levels_pay(monkeypatch, bitmaps_pay):
    """... and let extra slabs pay, so a small budget splits the heavy
    columns over several levels."""
    for mod in (tbd, jbd):
        monkeypatch.setattr(mod, "_MIN_LEVEL_REM", 1)
        monkeypatch.setattr(mod, "_MIN_LEVEL_COVER", 1)


def test_edge_intersection_counts():
    rng = np.random.default_rng(6)
    pat = rng.random((30, 30)) < 0.3
    pat = (pat | pat.T) & ~np.eye(30, dtype=bool)
    L, U = np.tril(pat, -1), np.triu(pat, 1)
    ei, ej = np.nonzero(L)
    got = gt.masked_spgemm_counts((ei, ej), L, U, device=CPU)
    want = np.array([(L[i] & U[j]).sum() for i, j in zip(ei, ej)])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(
        jsp.masked_spgemm_counts((ei, ej), L, U)))
    packed = gt.pack_pattern(L, device=CPU)
    assert gt.edge_intersection_counts(packed, packed, ei[:0],
                                       ej[:0]).shape == (0,)


def test_tricount_sparse_matches_dense():
    rng = np.random.default_rng(7)
    pat = rng.random((60, 60)) < 0.15
    pat = (pat | pat.T) & ~np.eye(60, dtype=bool)
    want = int(((pat.astype(np.int64) @ pat) * pat).sum()) // 6
    A = gt.Matrix.from_dense(pat.astype(np.float64), gt.FP64, pattern=pat,
                             device=CPU)
    assert gt.tricount_sparse(A) == want
    Aj = gb.Matrix.from_dense(pat.astype(np.float64), gb.FP64, pattern=pat)
    assert jsp.tricount_sparse(Aj) == want
    I, J = np.nonzero(pat)
    At, _ = _csr_both(I, J, 60)
    assert gt.tricount_sparse(At) == want


def test_ktruss_sparse_matches_bitmap():
    # 5-clique + path
    I, J = [], []
    for i in range(5):
        for j in range(i + 1, 5):
            I += [i, j]
            J += [j, i]
    for i in range(5, 8):
        I += [i, i + 1]
        J += [i + 1, i]
    I, J = np.array(I), np.array(J)
    At, Aj = _bitmap_both(I, J, 9)
    (ei, ej, supp), steps = gt.ktruss_sparse(At, 4)
    (eij, ejj, suppj), stepsj = jsp.ktruss_sparse(Aj, 4)
    assert steps == stepsj
    assert np.array_equal(ei, eij) and np.array_equal(ej, ejj)
    assert np.array_equal(supp, np.asarray(suppj))
    C, _ = jmodels.ktruss(Aj, 4)
    want = C.pattern_np()
    got = np.zeros_like(want)
    keep = supp >= 2
    got[ei[keep], ej[keep]] = True
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        gt.ktruss_sparse(At, 2)


def test_ktruss_csr_matches_bitmap():
    n = 80
    I, J = _sym_graph(42, n, 600)
    At, Aj = _csr_both(I, J, n, "UINT32")
    Bt, _ = _bitmap_both(I, J, n)
    for k in (3, 4, 5):
        (Ic, Jc, Sc), sc = gt.ktruss_sparse(At, k)
        (Ib, Jb, Sb), _ = gt.ktruss_sparse(Bt, k)
        (Ij, Jj, Sj), scj = jsp.ktruss_sparse(Aj, k)
        got = {(int(i), int(j)): int(s) for i, j, s in zip(Ic, Jc, Sc)}
        want = {(int(i), int(j)): int(s) for i, j, s in zip(Ib, Jb, Sb)}
        ref = {(int(i), int(j)): int(s) for i, j, s in zip(Ij, Jj, Sj)}
        assert got == want == ref and sc == scj


def test_allktruss_csr_matches_bitmap():
    n = 60
    I, J = _sym_graph(43, n, 400)
    At, Aj = _csr_both(I, J, n, "UINT32")
    _, Bj = _bitmap_both(I, J, n)
    got = gt.allktruss_esc(At)
    want = jmodels.allktruss(Bj)
    assert got == jsp.allktruss_esc(Aj)
    assert {k: v["nedges"] for k, v in got.items()} == \
           {k: v["nedges"] for k, v in want.items()}
    assert {k: v["nt"] for k, v in got.items()} == \
           {k: v["nt"] for k, v in want.items()}
    # kmax stops the sweep; the k entry equals ktruss_esc(A, k)'s truss
    part = gt.allktruss_esc(At, kmax=4)
    assert sorted(part) == [3, 4] and part[4] == got[4]


def test_tricount_and_ktruss_route_through_auto(monkeypatch):
    I, J = _powerlaw(13, n=400)
    n = 400
    At, Aj = _csr_both(I, J, n)
    Lt, Ut = gt.tricount_prep_csr(At)
    want = int(gt.masked_pair_counts(Lt, Lt, Ut).sum(dtype=torch.int64))
    assert gt.tricount_esc(Lt, Ut) == want
    # k-truss on the undirected pattern agrees with the pure engine
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    t1 = gt.ktruss_esc(At, 4)
    assert gt.last_axb_method() == "bitdot:ktruss_incremental"
    t1j = jtri.ktruss_esc(Aj, 4)
    assert jax_last_method() == "bitdot:ktruss_incremental"
    _same_truss(t1, t1j)
    monkeypatch.setattr(tbd, "_MIN_LANES", 1 << 22)
    t2 = gt.ktruss_esc(At, 4)
    assert t1[0].nvals == t2[0].nvals and t1[2] == t2[2]
    assert torch.equal(torch.sort(t1[1][:t1[0].nvals]).values,
                       torch.sort(t2[1][:t2[0].nvals]).values)


@pytest.mark.parametrize("k", [3, 4, 6])
def test_ktruss_incremental_matches_fallback(bitmaps_pay, k):
    I, J = _powerlaw(41, n=400, mult=4)
    At, Aj = _csr_both(I, J, 400)
    t1 = gt.ktruss_esc(At, k)                         # incremental
    assert gt.last_axb_method() == "bitdot:ktruss_incremental"
    t2 = ttri._ktruss_sort_merge(At, k, 1 << 26, 1000)
    assert t1[0].nvals == t2[0].nvals and t1[2] == t2[2]
    I1, J1, _ = t1[0].extractTuples()
    I2, J2, _ = t2[0].extractTuples()
    assert np.array_equal(I1, I2) and np.array_equal(J1, J2)
    assert torch.equal(torch.sort(t1[1][:t1[0].nvals]).values,
                       torch.sort(t2[1][:t2[0].nvals]).values)
    _same_truss(t1, jtri.ktruss_esc(Aj, k))
    _same_truss(t2, jtri._ktruss_sort_merge(Aj, k, 1 << 26, 1000))


def test_ktruss_multilevel_plan_matches_jax(levels_pay):
    """A budget small enough for several slabs: every level re-packs
    under the liveness masks each sweep."""
    I, J = _powerlaw(5, n=400, mult=4)
    At, Aj = _csr_both(I, J, 400)
    budget = 1 << 16
    pt = tbd.build_bitdot_plan(At, At, At, budget_bytes=budget,
                               keep_entry_lists=True)
    assert pt is not None and len(pt.levels) > 1
    _same_truss(gt.ktruss_esc(At, 5, budget_bytes=budget),
                jtri.ktruss_esc(Aj, 5, budget_bytes=budget))


def test_keep_entry_lists_and_liveness_match_jax(levels_pay):
    I, J = _powerlaw(3, n=400)
    At, Aj = _csr_both(I, J, 400)
    budget = 1 << 16
    pt = tbd.build_bitdot_plan(At, At, At, budget_bytes=budget,
                               keep_entry_lists=True)
    assert len(pt.levels) > 1
    pj = jbd.build_bitdot_plan(Aj, Aj, Aj, budget_bytes=budget,
                               keep_entry_lists=True)
    assert len(pt.levels) == len(pj.levels)
    for lt, lj in zip(pt.levels, pj.levels):
        na, nb = lt.a_eids.shape[0], lt.b_eids.shape[0]
        assert na == lt.a_rows.shape[0] and nb == lt.b_js.shape[0]
        assert np.array_equal(lt.a_eids.numpy(), np.asarray(lj.a_eids)[:na])
        assert np.array_equal(lt.b_eids.numpy(), np.asarray(lj.b_eids)[:nb])
    nl = pt.A_light.nvals
    assert np.array_equal(pt.light_eids[:nl].numpy(),
                          np.asarray(pj.light_eids)[:nl])
    rng = np.random.default_rng(4)
    alive = rng.random(At.nzmax) < 0.7
    alive[At.nvals:] = False
    got = tbd.bitdot_counts(pt, At, alive_a=torch.from_numpy(alive),
                            alive_b=torch.from_numpy(alive))
    want = jbd.bitdot_counts(pj, Aj, alive_a=jnp.asarray(alive),
                             alive_b=jnp.asarray(alive))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # without liveness the cached panels give the plain counts
    assert np.array_equal(tbd.bitdot_counts(pt, At).numpy(),
                          np.asarray(jbd.bitdot_counts(pj, Aj)))
    # a plan without entry lists refuses liveness
    p0 = tbd.build_bitdot_plan(At, At, At, budget_bytes=budget)
    with pytest.raises(ValueError):
        tbd.bitdot_counts(p0, At, alive_a=torch.from_numpy(alive))


def test_ktruss_empty_and_small_k():
    e = np.zeros(0, np.int64)
    At, Aj = _csr_both(e, e, 10)
    truss, sup, steps = gt.ktruss_esc(At, 3)
    assert truss.nvals == 0 and steps == 0 and sup.shape == (At.nzmax,)
    with pytest.raises(ValueError):
        gt.ktruss_esc(At, 2)
