"""PyTorch port, the slices end to end: parity with the JAX package on
the main path's graph families at small size.

Wathen FEM graphs (banded: band-ring engine) and R-MAT power-law graphs
(bitmap popcount + sort-merge) are generated by each package's own
copy of the generators, built into containers, prepped and counted by
``tricount_auto`` / ``tricount_esc``.  Counts must be equal, and each
engine the port records must map to the JAX package's through
``jax_engine_name``.

The second slice, the masked valued product, runs ``mxm(C0, M, None,
"plus_times", L, U)`` on the prepped R-MAT graphs with bench.py's value
recipe in both packages: nnzC and the pattern must be equal, values
within rtol=2e-5, atol=2e-6 (reassociation).

The third slice, SpMV, runs ``mxv``/``vxm`` on Wathen (through the BSR
tile engine) and the whole-loop BFS / PageRank and a frontier step on
R-MAT, with the tolerances stated per test.

The fifth slice, the BSR tile engine and k-truss, counts Wathen
triangles through ``tricount_bsr_pallas`` from COO tiles, runs
``masked_mxm`` in its four modes on Wathen with bench.py's values
(counts and patterns exact, values within rtol=1e-5, atol=1e-4), and
runs ``ktruss_esc`` / ``allktruss_esc`` on R-MAT (exact).

The ninth slice runs the reference's ``tri_demo`` flow through the
operations; the tenth, pending tuples, extract/assign and the graph
models BFS, MIS and PageRank on R-MAT (exact, ``dpagerank`` within
rtol 1e-12)."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import models as gb_models
from graphblas_tpu import sparse as jsp
from graphblas_tpu.models.generate import wathen_coo as jax_wathen_coo
from graphblas_tpu.models.rmat import rmat_edges as jax_rmat_edges
from graphblas_tpu.models.rmat import symmetrize_pattern as jax_symmetrize
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.ops.mxm import mxm as jax_mxm
from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.sparse import tri as jtri
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import bitdot as tbd


def _lu_both(iu, ju, n):
    lo, up = iu > ju, iu < ju
    out = []
    for sel in (lo, up):
        X = np.ones(int(sel.sum()), bool)
        out.append((gt.csr_from_coo(iu[sel], ju[sel], X, n, n, type=gt.BOOL,
                                    sum_duplicates=False, device="cpu"),
                    jsp.CsrMatrix.from_coo(iu[sel], ju[sel], X, n, n,
                                           type=gb.BOOL,
                                           sum_duplicates=False)))
    return out


def _check_engine(port_name):
    assert gt.jax_engine_name(port_name) == jax_last_method(), \
        (port_name, jax_last_method())


@pytest.mark.parametrize("nx", [8, 16])
def test_wathen_slice_matches_jax(nx):
    I, J, X, n = gt.wathen_coo(nx, nx, seed=1)
    Ij, Jj, Xj, nj = jax_wathen_coo(nx, nx, seed=1)
    assert n == nj and np.array_equal(I, Ij) and np.array_equal(J, Jj)
    assert np.array_equal(X, Xj)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    (Lt, Lj), (Ut, Uj) = _lu_both(iu[off], ju[off], n)
    got = gt.tricount_auto(Lt, Ut)
    engine = gt.last_axb_method()
    want = jtri.tricount_auto(Lj, Uj)
    assert engine == "torch:tri_band_ring"
    assert got == want
    _check_engine(engine)
    assert gt.tricount_esc(Lt, Ut) == jtri.tricount_esc(Lj, Uj) == want
    _check_engine(gt.last_axb_method())
    assert gt.tricount_window(Lt, Ut) == want


def _rmat_both(scale):
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    Ij, Jj = jax_rmat_edges(scale, 16, seed=7)
    assert np.array_equal(I, Ij) and np.array_equal(J, Jj)
    I, J = gt.symmetrize_pattern(I, J, n)
    Ij, Jj = jax_symmetrize(Ij, Jj, n)
    assert np.array_equal(I, Ij) and np.array_equal(J, Jj)
    X = np.ones(len(I), bool)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)
    return gt.tricount_prep_csr(At), jtri.tricount_prep_csr(Aj)


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_slice_matches_jax(scale):
    (Lt, Ut), (Lj, Uj) = _rmat_both(scale)
    want = jtri.tricount_esc(Lj, Uj)
    assert gt.tricount_esc(Lt, Ut) == want
    _check_engine(gt.last_axb_method())
    assert gt.tricount_auto(Lt, Ut) == jtri.tricount_auto(Lj, Uj) == want
    _check_engine(gt.last_axb_method())


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_bitdot_engine_matches_jax(monkeypatch, scale):
    # at these sizes the planner would leave everything to the
    # sort-merge; let the bitmap panels take the heavy columns
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    (Lt, Ut), (Lj, Uj) = _rmat_both(scale)
    got = gt.tricount_esc(Lt, Ut)
    engine = gt.last_axb_method()
    assert engine.startswith("bitdot:")
    assert got == jtri.tricount_esc(Lj, Uj)
    _check_engine(engine)


def _with_values(rng, Lt, Lj):
    """bench.py's value recipe: uniform [0.5, 1.5) float32 on L's pattern,
    the same values for both packages."""
    hp = Lj._options["host_pattern"]
    I, J = hp[0][:Lj.nvals], hp[1][:Lj.nvals]
    X = rng.random(len(I)).astype(np.float32) + 0.5
    return (gt.csr_from_coo(I, J, X, Lt.nrows, Lt.ncols, type=gt.FP32,
                            sum_duplicates=False, device="cpu"),
            jsp.CsrMatrix.from_coo(I, J, X, Lj.nrows, Lj.ncols,
                                   type=gb.FP32, sum_duplicates=False))


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_valued_mxm_matches_jax(scale):
    (Lt, Ut), (Lj, Uj) = _rmat_both(scale)
    rng = np.random.default_rng(3)
    # values drawn for L, then U, then the mask M (L's pattern)
    (Lvt, Lvj), (Uvt, Uvj), (Mvt, Mvj) = (_with_values(rng, a, b) for a, b
                                          in ((Lt, Lj), (Ut, Uj), (Lt, Lj)))
    n = Lt.nrows
    e = np.zeros(0, np.int64)
    C0t = gt.csr_from_coo(e, e, np.zeros(0, np.float32), n, n,
                          type=gt.FP32, device="cpu")
    C0j = jsp.CsrMatrix.from_coo(e, e, np.zeros(0, np.float32), n, n,
                                 type=gb.FP32)
    Ct = gt.mxm(C0t, Mvt, None, "plus_times", Lvt, Uvt)
    engine = gt.last_axb_method()
    Cj = jax_mxm(C0j, Mvj, None, "plus_times", Lvj, Uvj)
    assert gt.jax_engine_name(engine) == jax_last_method()
    assert Ct.nvals == Cj.nvals
    It, Jt, Xt = Ct.extractTuples()
    Ij, Jj, Xj = Cj.extractTuples()
    assert np.array_equal(It, np.asarray(Ij))
    assert np.array_equal(Jt, np.asarray(Jj))
    np.testing.assert_allclose(Xt, np.asarray(Xj), rtol=2e-5, atol=2e-6)
    # the product's pattern is the mask's entries that close a wedge
    assert Ct.nvals <= Mvt.nvals


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_valdot_matches_jax(monkeypatch, scale):
    """The value-panel engine itself on the same product (at these
    sizes mxm takes the small dense branch; let the plans take the
    heavy columns)."""
    from graphblas_tpu.sparse import valdot as jvd
    from graphblas_tpu_torch.sparse import valdot as tvd
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    (Lt, Ut), (Lj, Uj) = _rmat_both(scale)
    rng = np.random.default_rng(3)
    (Lvt, Lvj), (Uvt, Uvj), (Mvt, Mvj) = (_with_values(rng, a, b) for a, b
                                          in ((Lt, Lj), (Ut, Uj), (Lt, Lj)))
    srt = gt.semiring.plus_times[gt.FP32]
    Ct = tvd.valdot_masked_spgemm(srt, Lvt, Uvt, Mvt)
    engine = gt.last_axb_method()
    Cj = jvd.valdot_masked_spgemm(gb.semiring.plus_times[gb.FP32], Lvj,
                                  Uvj, Mvj)
    assert engine.startswith("valdot:")
    assert gt.jax_engine_name(engine) == jax_last_method()
    assert Ct.nvals == Cj.nvals
    It, Jt, Xt = Ct.extractTuples()
    Ij, Jj, Xj = Cj.extractTuples()
    assert np.array_equal(It, np.asarray(Ij))
    assert np.array_equal(Jt, np.asarray(Jj))
    np.testing.assert_allclose(Xt, np.asarray(Xj), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("nx", [8, 16])
def test_wathen_spmv_slice_matches_jax(nx):
    """The SpMV slice on a Wathen FEM matrix (duplicates summed, FP32):
    ``mxv`` with a dense u through the BSR tile engine (forced on the
    CPU in both packages), against the JAX package's ``bsr_spmv``:
    pattern equal, values within 2 * K * 2^-24 * sum |a x| per row;
    ``vxm`` with TRAN1 (the dense-x engine) against the JAX package's
    ``vxm`` (its sparse-x engine, a float32 segment sum), within the same
    bound (the FEM rows cancel, so a relative tolerance does not fit)."""
    import jax.numpy as jnp
    from graphblas_tpu.sparse import pallas_spmv as jps
    from graphblas_tpu_torch import convert
    I, J, X, n = gt.wathen_coo(nx, nx, seed=1)
    Aj = jsp.CsrMatrix.from_coo(I, J, X.astype(np.float32), n, n,
                                type=gb.FP32)
    At = convert.from_jax(Aj, device="cpu")
    Aj._options["bsr_spmv"] = At._options["bsr_spmv"] = True
    x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    w = gt.mxv(gt.Vector.new(gt.FP32, n, device="cpu"), None, None,
               "plus_times", At, gt.Vector.from_dense(x, device="cpu"))
    engine = gt.last_axb_method()
    yj, pj = jps.bsr_spmv(gb.semiring.plus_times[gb.FP32], Aj,
                          jnp.asarray(x), interpret=True)
    assert engine == "torch:bsr_spmv"
    _check_engine(engine)
    assert np.array_equal(w.pattern_np(), np.asarray(pj))
    It, Jt, Xt = At.extractTuples()
    mag = np.zeros(n)
    np.add.at(mag, It, np.abs(Xt.astype(np.float64) * x[Jt]))
    bound = 2 * np.bincount(It, minlength=n) * 2.0 ** -24 * mag
    assert np.all(np.abs(w.to_dense() - np.asarray(yj)) <= bound)
    uj = gb.Vector.from_dense(x, gb.FP32)
    wt = gt.vxm(gt.Vector.new(gt.FP32, n, device="cpu"), None, None,
                "plus_times", gt.Vector.from_dense(x, device="cpu"), At,
                gt.TRAN1)
    wj = gb.vxm(gb.Vector.new(gb.FP32, n), None, None,
                gb.semiring.plus_times[gb.FP32], uj, Aj, gb.TRAN1)
    assert np.array_equal(wt.pattern_np(), wj.pattern_np())
    # u' A' = (A u)': the same rows' terms
    assert np.all(np.abs(wt.to_dense() - wj.to_dense()) <= bound)


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_spmv_slice_matches_jax(scale):
    """The SpMV slice on the symmetrized R-MAT graph: BFS levels and the
    PageRank top-10 exactly, PageRank within 1e-5 relative, one frontier
    step (vxm lor_land, complemented mask, REPLACE) exactly, and a dense
    plus_times[FP32] mxv within rtol=1e-5, atol=1e-6."""
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    I, J = gt.symmetrize_pattern(I, J, n)
    X = np.ones(len(I), bool)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)
    assert np.array_equal(gt.bfs_csr(At, 0), jsp.bfs_csr(Aj, 0))
    rt, rj = gt.pagerank_csr(At, iters=20), jsp.pagerank_csr(Aj, iters=20)
    np.testing.assert_allclose(rt, rj, rtol=1e-5)
    assert np.array_equal(np.argsort(-rt, kind="stable")[:10],
                          np.argsort(-rj, kind="stable")[:10])
    q = np.zeros(n, bool)
    q[0] = True
    qt = gt.Vector.from_dense(q, gt.BOOL, pattern=q, device="cpu")
    qj = gb.Vector.from_dense(q, gb.BOOL, pattern=q)
    wt = gt.vxm(gt.Vector.new(gt.BOOL, n, device="cpu"), qt, None,
                "lor_land", qt, At,
                gt.Descriptor(mask_scmp=True, replace=True, tran1=True))
    assert gt.last_axb_method() == "spmv:sparse_x"
    wj = gb.vxm(gb.Vector.new(gb.BOOL, n), qj, None,
                gb.semiring.lor_land[gb.BOOL], qj, Aj,
                gb.Descriptor(mask_scmp=True, replace=True, tran1=True))
    assert np.array_equal(wt.pattern_np(), wj.pattern_np())
    assert np.array_equal(wt.to_dense(), wj.to_dense())
    x = np.random.default_rng(5).random(n).astype(np.float32)
    yt = gt.mxv(gt.Vector.new(gt.FP32, n, device="cpu"), None, None,
                "plus_times_fp32", At, gt.Vector.from_dense(x, device="cpu"))
    assert gt.last_axb_method() == "spmv:dense_x"
    yj = gb.mxv(gb.Vector.new(gb.FP32, n), None, None,
                gb.semiring.plus_times[gb.FP32], Aj,
                gb.Vector.from_dense(x, gb.FP32))
    assert np.array_equal(yt.pattern_np(), yj.pattern_np())
    np.testing.assert_allclose(yt.to_dense(), yj.to_dense(), rtol=1e-5,
                               atol=1e-6)


def _apsp_d0(pkg, scale, device_kw):
    """The min-plus squaring start of the fourth slice: R-MAT ``scale``
    (edge factor 16, seed 7, symmetrized), weights U[1, 10) float32 from
    ``default_rng(5)`` on the upper triangle, mirrored, and a 0
    diagonal, as a bitmap FP32 Matrix of package ``pkg``."""
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    I, J = gt.symmetrize_pattern(I, J, n)
    up = I < J
    w = (1 + 9 * np.random.default_rng(5).random(int(up.sum()))
         ).astype(np.float32)
    d = np.arange(n)
    Iw = np.concatenate([I[up], J[up], d])
    Jw = np.concatenate([J[up], I[up], d])
    Xw = np.concatenate([w, w, np.zeros(n, np.float32)])
    return pkg.Matrix.from_coo(Iw, Jw, Xw, n, n, type=pkg.FP32, **device_kw)


def test_rmat_min_plus_squaring_matches_jax():
    """The fourth slice on R-MAT scale 7: all-pairs shortest paths by
    ``D = mxm(D, None, min, "min_plus", D, D)`` until D stops changing,
    port against JAX after every product, exact (min is exact and each
    float32 add correctly rounded, in both packages' generic path on the
    CPU); the fixed point against scipy's float64 Dijkstra, the
    reachability exactly and distances within rtol=1e-5."""
    from scipy.sparse.csgraph import shortest_path
    Dt = _apsp_d0(gt, 7, {"device": "cpu"})
    Dj = _apsp_d0(gb, 7, {})
    assert np.array_equal(Dt.to_dense(), Dj.to_dense())
    for products in range(1, 13):
        Nt = gt.mxm(Dt, None, gt.binary.min[gt.FP32], "min_plus", Dt, Dt)
        engine = gt.last_axb_method()
        Nj = gb.mxm(Dj, None, gb.binary.min[gb.FP32], "min_plus", Dj, Dj)
        _check_engine(engine)
        assert engine == "vpu:generic"
        assert np.array_equal(Nt.pattern_np(), Nj.pattern_np())
        assert np.array_equal(Nt.to_dense(), Nj.to_dense())
        same = (np.array_equal(Nt.pattern_np(), Dt.pattern_np())
                and np.array_equal(Nt.to_dense(), Dt.to_dense()))
        Dt, Dj = Nt, Nj
        if same:
            break
    assert same and products >= 3
    I, J, X = Dt.extractTuples()
    n = Dt.nrows
    A0 = _apsp_d0(gt, 7, {"device": "cpu"})
    Ia, Ja, Xa = A0.extractTuples()
    off = Ia != Ja
    import scipy.sparse as ssp
    G = ssp.csr_matrix((Xa[off].astype(np.float64), (Ia[off], Ja[off])),
                       shape=(n, n))
    ref = shortest_path(G, method="D", directed=False)
    assert np.array_equal(Dt.pattern_np(), np.isfinite(ref))
    np.testing.assert_allclose(X, ref[I, J], rtol=1e-5)


def _wathen_pattern(nx):
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    return iu[off], ju[off], n


@pytest.mark.parametrize("nx", [8, 10])
def test_wathen_bsr_slice_matches_jax(nx):
    iu, ju, n = _wathen_pattern(nx)
    lo, up = iu > ju, iu < ju
    Lt = gt.tile_pattern_from_coo(iu[lo], ju[lo], (n, n), device="cpu")
    Ut = gt.tile_pattern_from_coo(iu[up], ju[up], (n, n), device="cpu")
    C, _ = gt.bsr_masked_count_pallas(Lt, Lt, Ut)
    ntri = int(C.sum())
    Lj = jsp.tile_pattern_from_coo(iu[lo], ju[lo], (n, n))
    Uj = jsp.tile_pattern_from_coo(iu[up], ju[up], (n, n))
    Cj, _ = jsp.bsr_masked_count_pallas(Lj, Lj, Uj)
    assert np.array_equal(C.numpy(), np.asarray(Cj))
    (Lc, Lcj), (Uc, Ucj) = _lu_both(iu, ju, n)
    assert ntri == gt.tricount_auto(Lc, Uc) == jtri.tricount_auto(Lcj, Ucj)
    P = np.zeros((n, n), bool)
    P[iu, ju] = True
    assert gt.tricount_bsr_pallas(np.tril(P, -1), np.triu(P, 1),
                                  device="cpu") == ntri


@pytest.mark.parametrize("sr", [None, "plus_land_INT32", "lor_land_BOOL",
                                "plus_times_FP32"])
def test_wathen_masked_mxm_modes_match_jax(sr):
    """masked_mxm(L, L, L) on Wathen nx=8 with bench.py's values on L."""
    from graphblas_tpu.core.semirings import semiring as jsemiring
    iu, ju, n = _wathen_pattern(8)
    lo = iu > ju
    (Lt, Lj), _ = _lu_both(iu, ju, n)
    Lvt, Lvj = _with_values(np.random.default_rng(3), Lt, Lj)
    if sr is None:
        srt = srj = None
    else:
        name, tname = sr.rsplit("_", 1)
        srt = getattr(gt.semiring, name)[getattr(gt, tname)]
        srj = getattr(jsemiring, name)[getattr(gb, tname)]
    Ct = gt.masked_mxm(Lvt, Lvt, Lvt, semiring=srt)
    engine = gt.last_axb_method()
    Cj = jsp.masked_mxm(Lvj, Lvj, Lvj, semiring=srj)
    _check_engine(engine)
    assert Ct.type.name == Cj.type.name
    assert np.array_equal(Ct.pattern_np(), Cj.pattern_np())
    if sr == "plus_times_FP32":
        np.testing.assert_allclose(Ct.to_dense(), Cj.to_dense(), rtol=1e-5,
                                   atol=1e-4)
        # against the bitmap mxm on the same mask
        want = gt.mxm(gt.Matrix.new(gt.FP32, n, n, device="cpu"), Lvt, None,
                      srt, Lvt, Lvt)
        assert np.array_equal(Ct.pattern_np(), want.pattern_np())
        np.testing.assert_allclose(Ct.to_dense(), want.to_dense(),
                                   rtol=1e-5, atol=1e-4)
    else:
        assert np.array_equal(Ct.to_dense(), Cj.to_dense())
    assert int(Ct.pattern_np().sum()) <= int(lo.sum())


def test_rmat_ktruss_slice_matches_jax(monkeypatch):
    """ktruss_esc on the symmetrized R-MAT 10 graph through the
    incremental bitdot engine, and allktruss_esc, in both packages."""
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    n = 1 << 10
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(10, 16, seed=7), n)
    X = np.ones(len(I), bool)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)
    for k in (5, 8):
        tt, ct, st = gt.ktruss_esc(At, k)
        assert gt.last_axb_method() == "bitdot:ktruss_incremental"
        tj, cj, sj = jtri.ktruss_esc(Aj, k)
        _check_engine("bitdot:ktruss_incremental")
        assert (tt.nvals, st) == (tj.nvals, sj)
        It, Jt, _ = tt.extractTuples()
        Ij, Jj, _ = tj.extractTuples()
        assert np.array_equal(It, np.asarray(Ij))
        assert np.array_equal(Jt, np.asarray(Jj))
        assert np.array_equal(ct[:tt.nvals].numpy(),
                              np.asarray(cj)[:tj.nvals])
    got = gt.allktruss_esc(At, kmax=6)
    assert got == jtri.allktruss_esc(Aj, kmax=6)
    tt, _, _ = gt.ktruss_esc(At, 5)
    assert got[5]["nedges"] == tt.nvals // 2


def _tuples_equal(Xt, Xj):
    It, Jt, Vt = Xt.extractTuples()
    Ij, Jj, Vj = Xj.extractTuples()
    assert np.array_equal(It, np.asarray(Ij))
    assert np.array_equal(Jt, np.asarray(Jj))
    assert np.array_equal(Vt, np.asarray(Vj))


def test_rmat_ops_flow_matches_jax():
    """The reference's tri_demo flow through the operations on the
    symmetrized R-MAT 10 graph as CSR, step by step against the JAX
    package: select tril/triu, eWiseAdd(lor), the degree reduce, the
    SandiaDot product mxm(C<L>, plus_times[UINT32], L, U') and its sum
    (exact; the count equals tricount_esc's)."""
    n = 1 << 10
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(10, 16, seed=7), n)
    X = np.ones(len(I), bool)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)

    def empty(pkg, t, **kw):
        e = np.zeros(0, np.int64)
        cls = gt.CsrMatrix if pkg is gt else jsp.CsrMatrix
        return cls.from_coo(e, e, np.zeros(0, t.dtype), n, n, type=t, **kw)

    # 1. L = tril(A, -1), U = triu(A, 1)
    Lt = gt.select(empty(gt, gt.BOOL, device="cpu"), None, None,
                   gt.selectop.tril, At, -1)
    Ut = gt.select(empty(gt, gt.BOOL, device="cpu"), None, None,
                   gt.selectop.triu, At, 1)
    Lj = gb.select(empty(gb, gb.BOOL), None, None, gb.selectop.tril, Aj, -1)
    Uj = gb.select(empty(gb, gb.BOOL), None, None, gb.selectop.triu, Aj, 1)
    _tuples_equal(Lt, Lj)
    _tuples_equal(Ut, Uj)
    # 2. L ∪ U has A's pattern
    St = gt.eWiseAdd(empty(gt, gt.BOOL, device="cpu"), None, None,
                     gt.binary.lor[gt.BOOL], Lt, Ut)
    Sj = gb.eWiseAdd(empty(gb, gb.BOOL), None, None, gb.binary.lor[gb.BOOL],
                     Lj, Uj)
    _tuples_equal(St, Sj)
    _tuples_equal(St, At)
    # 3. the degrees
    dt = gt.reduce_to_vector(gt.Vector.new(gt.INT64, n, device="cpu"), None,
                             None, gt.monoid.plus[gt.INT64], At)
    dj = gb.reduce_to_vector(gb.Vector.new(gb.INT64, n), None, None,
                             gb.monoid.plus[gb.INT64], Aj)
    assert np.array_equal(dt.to_dense(), np.asarray(dj.values))
    assert np.array_equal(dt.to_dense(), np.bincount(I, minlength=n))
    # 4. C<L> = L * U' over plus_times[UINT32], 5. its sum
    Ct = gt.mxm(empty(gt, gt.UINT32, device="cpu"), Lt, None,
                gt.semiring.plus_times[gt.UINT32], Lt, Ut, gt.TRAN1)
    Cj = gb.mxm(empty(gb, gb.UINT32), Lj, None,
                gb.semiring.plus_times[gb.UINT32], Lj, Uj, gb.TRAN1)
    _tuples_equal(Ct, Cj)
    ntri = gt.reduce_to_scalar(None, gt.monoid.plus[gt.INT64], Ct)
    assert ntri == gb.reduce_to_scalar(None, gb.monoid.plus[gb.INT64], Cj)
    assert ntri == gt.tricount_esc(Lt, Ut) > 0
    # transpose(L) = U
    _tuples_equal(gt.transpose(empty(gt, gt.BOOL, device="cpu"), None, None,
                               Lt), Ut)


def test_rmat_graph_models_flow_matches_jax():
    """The tenth slice end to end on the symmetrized R-MAT 9 graph as
    CSR, step by step against the JAX package (all exact): 4,000
    buffered ``setElement`` calls (half on existing entries, runs with
    and without ``accum=plus``) and one ``wait``; ``removeElement`` and
    ``resize``; the induced subgraph on a random vertex set by
    ``extract`` and an ``assign`` of it, doubled, back into the graph
    under the graph's own mask; ``bfs5m``, ``bfs6`` and ``mis`` on the
    graph; ``dpagerank`` (within rtol 1e-12) and ``ipagerank`` on its
    bitmap."""
    scale = 9
    n = 1 << scale
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(scale, 16, seed=7), n)
    rng = np.random.default_rng(23)
    X = rng.integers(1, 100, len(I)).astype(np.int64)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.INT64, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.INT64,
                                sum_duplicates=False)
    # 1. setElement: half on existing entries; runs of 500 alternate
    # between overwrite and accum=plus
    k = 4000
    old = rng.integers(0, len(I), k // 2)
    ui = np.concatenate([I[old], rng.integers(0, n, k // 2)])
    uj = np.concatenate([J[old], rng.integers(0, n, k // 2)])
    ux = rng.integers(-50, 50, k)
    perm = rng.permutation(k)
    ui, uj, ux = ui[perm], uj[perm], ux[perm]
    Bt, Bj = At, Aj
    for e in range(k):
        acc = (e // 500) % 2 == 1
        Bt = Bt.setElement(np.int64(ux[e]), int(ui[e]), int(uj[e]),
                           accum=gt.binary.plus[gt.INT64] if acc else None)
        Bj = Bj.setElement(np.int64(ux[e]), int(ui[e]), int(uj[e]),
                           accum=gb.binary.plus[gb.INT64] if acc else None)
    assert len(Bt._pending) == k
    Bt, Bj = Bt.wait(), Bj.wait()
    _tuples_equal(Bt, Bj)
    # 2. removeElement, resize
    Rt = Bt.removeElement(int(I[0]), int(J[0])).resize(n - 7, n - 3)
    Rj = Bj.removeElement(int(I[0]), int(J[0])).resize(n - 7, n - 3)
    _tuples_equal(Rt, Rj)
    # 3. the induced subgraph, and an assign of it (doubled) back into
    # the graph under the graph's own mask
    S = np.sort(rng.choice(n, n // 4, replace=False))
    m = len(S)
    e64 = np.zeros(0, np.int64)
    Gt = gt.extract(gt.CsrMatrix.from_coo(e64, e64, e64, m, m, type=gt.INT64,
                                          device="cpu"), None, None, Bt, S, S)
    Gj = gb.extract(jsp.CsrMatrix.from_coo(e64, e64, e64, m, m,
                                           type=gb.INT64), None, None, Bj, S,
                    S)
    _tuples_equal(Gt, Gj)
    Dt = gt.apply(Gt, None, gt.binary.plus[gt.INT64], gt.unary.identity[
        gt.INT64], Gt)
    Dj = gb.apply(Gj, None, gb.binary.plus[gb.INT64], gb.unary.identity[
        gb.INT64], Gj)
    _tuples_equal(Dt, Dj)
    Ct = gt.assign(Bt, At, None, Dt, S, S)
    Cj = gb.assign(Bj, Aj, None, Dj, S, S)
    _tuples_equal(Ct, Cj)
    # 4. the graph models on the BOOL graph
    Xb = np.ones(len(I), bool)
    Ab_t = gt.csr_from_coo(I, J, Xb, n, n, type=gt.BOOL,
                           sum_duplicates=False, device="cpu")
    Ab_j = jsp.CsrMatrix.from_coo(I, J, Xb, n, n, type=gb.BOOL,
                                  sum_duplicates=False)
    for name in ("bfs5m", "bfs6"):
        _tuples_equal_vec(getattr(gt.models, name)(Ab_t, 0),
                          getattr(gb_models, name)(Ab_j, 0))
    _tuples_equal_vec(gt.models.mis(Ab_t, seed=42),
                      gb_models.mis(Ab_j, seed=42))
    # 5. PageRank on the bitmap R-MAT 8
    n8 = 256
    I8, J8 = gt.symmetrize_pattern(*gt.rmat_edges(8, 16, seed=7), n8)
    X8 = np.ones(len(I8), bool)
    Mt = gt.Matrix.from_coo(I8, J8, X8, n8, n8, type=gt.BOOL, device="cpu")
    Mj = gb.Matrix.from_coo(I8, J8, X8, n8, n8, type=gb.BOOL)
    dt, dj = dict(gt.models.dpagerank(Mt)), dict(gb_models.dpagerank(Mj))
    assert dt.keys() == dj.keys()
    assert np.allclose([dt[p] for p in sorted(dt)],
                       [dj[p] for p in sorted(dt)], rtol=1e-12, atol=0)
    assert gt.models.ipagerank(Mt) == gb_models.ipagerank(Mj)


def _tuples_equal_vec(vt, vj):
    assert vt.type.name == vj.type.name
    for x, y in zip(vt.extractTuples(), vj.extractTuples()):
        assert np.array_equal(x, np.asarray(y))


def _id_map(n):
    """A strictly increasing map of n vertices into [0, 2^60): n distinct
    int64 drawn with default_rng(61), sorted (order is kept, so tril/triu
    and the degree prep carry over)."""
    rng = np.random.default_rng(61)
    ids = np.unique(rng.integers(0, 1 << 60, 2 * n, dtype=np.int64))
    ids = np.sort(rng.choice(ids, n, replace=False))
    assert len(ids) == n and np.all(np.diff(ids) > 0)
    return ids


def _bfs_sparsevec(pkg, A, src: int, dim: int, device_kw):
    """The bfs5m loop on hypersparse containers: a SparseVec frontier,
    vxm over lor_land[BOOL] with the complemented structural visited mask
    and REPLACE, an eWiseAdd into visited.  Returns {id: level}."""
    SV = gt.SparseVec if pkg is gt else jsp.SparseVec
    t = pkg.BOOL
    e = np.zeros(0, np.int64)
    frontier = SV.from_coo(np.array([src], np.int64), np.array([True]), dim,
                           type=t, **device_kw)
    visited, level, depth = frontier, {src: 1}, 1
    desc = pkg.Descriptor(mask_scmp=True, replace=True, mask_structure=True)
    while frontier.nvals:
        depth += 1
        nxt = pkg.vxm(SV.from_coo(e, np.zeros(0, bool), dim, type=t,
                                  **device_kw), visited, None,
                      pkg.semiring.lor_land[t], frontier, A, desc)
        for i in nxt.ids():
            level[int(i)] = depth
        visited = pkg.eWiseAdd(visited, None, None, pkg.binary.lor[t],
                               visited, nxt)
        frontier = nxt
    return level


def test_rmat_hyper_slice_matches_jax():
    """The hypersparse slice on the symmetrized R-MAT 8 mapped into the
    2^60 id space: BFS by the SparseVec bfs5m loop and the masked
    SandiaDot count ``mxm(C<L>, plus_times[INT64], L, U, TRAN1)`` into a
    hypersparse C, through both packages; levels and counts exact, equal
    to ``bfs_csr`` and ``tricount_esc`` on the compact graph."""
    n, dim = 256, 1 << 60
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(8, 16, seed=7), n)
    ids = _id_map(n)
    X = np.ones(len(I), bool)
    Ht = gt.hyper_from_coo(ids[I], ids[J], X, dim, dim, type=gt.BOOL,
                           dup=None, device="cpu")
    Hj = jsp.hyper_from_coo(ids[I], ids[J], X, dim, dim, type=gb.BOOL,
                            dup=None)
    lt = _bfs_sparsevec(gt, Ht, int(ids[0]), dim, {"device": "cpu"})
    lj = _bfs_sparsevec(gb, Hj, int(ids[0]), dim, {})
    assert lt == lj
    A = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                        device="cpu")
    lv = gt.bfs_csr(A, 0)
    lv = lv.cpu().numpy() if hasattr(lv, "cpu") else np.asarray(lv)
    assert lt == {int(ids[v]): int(lv[v]) for v in np.nonzero(lv > 0)[0]}
    # the masked count on the degree-prepped graph
    Lc, Uc = gt.tricount_prep_csr(A)
    hyp = []
    for pkg, make, kw in ((gt, gt.hyper_from_coo, {"device": "cpu"}),
                          (gb, jsp.hyper_from_coo, {})):
        LU = []
        for X_ in (Lc, Uc):
            i_, j_, _ = X_.extractTuples()
            LU.append(make(ids[i_], ids[j_],
                           np.ones(len(i_), np.int64), dim, dim,
                           type=pkg.INT64, dup=None, **kw))
        e = np.zeros(0, np.int64)
        C = make(e, e, e, dim, dim, type=pkg.INT64, **kw)
        C = pkg.mxm(C, LU[0], None, pkg.semiring.plus_times[pkg.INT64],
                    LU[0], LU[1], pkg.Descriptor(tran1=True))
        hyp.append((C, int(pkg.reduce_to_scalar(
            None, pkg.monoid.plus[pkg.INT64], C))))
    _tuples_equal(hyp[0][0], hyp[1][0])
    assert hyp[0][1] == hyp[1][1] == int(gt.tricount_esc(Lc, Uc))


def _tri_semiring(pkg, T):
    """The struct SandiaDot semiring over {n: INT64, w: FP64}: n counts
    wedges, w carries the values' product."""
    add = pkg.BinaryOp("TRI_ADD", lambda a, b: {"n": a["n"] + b["n"],
                                                "w": a["w"] + b["w"]},
                       T, T, T)
    mult = pkg.BinaryOp("TRI_MUL", lambda a, b: {"n": a["n"] * b["n"],
                                                 "w": a["w"] * b["w"]},
                        T, T, T)
    mon = (gt.monoid_new if pkg is gt else gb.core.monoids.monoid_new)(
        add, {"n": 0, "w": 0.0})
    return (gt.semiring_new if pkg is gt else
            gb.core.semirings.semiring_new)(mon, mult), mon


def test_rmat_types_slice_matches_jax():
    """The user-defined types slice on R-MAT 10: ``dpagerank2_csr`` (the
    UDT PageRank semiring) against the JAX package's (same iterations,
    ranks within rtol 1e-12), and the struct SandiaDot product
    ``mxm(C<L>, sr, L, U, TRAN1)`` over {n: INT64, w: FP64} with n = 1
    and bench.py's U[0.5,1.5) values: the n field sums to the triangle
    count, the w field equals ``plus_times[FP64]`` on the same values,
    both equal to the JAX package's struct product."""
    n = 1 << 10
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(10, 16, seed=7), n)
    X = np.ones(len(I), bool)
    A = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                        device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)
    got, it_g = gt.models.dpagerank2_csr(A)
    want, it_w = gb_models.pagerank.dpagerank2_csr(Aj)
    assert it_g == it_w
    w = dict(want)
    assert set(w) == {p for p, _ in got}
    for p, r in got:
        assert abs(r - w[p]) <= 1e-12 * w[p]
    # the struct SandiaDot count
    Lc, Uc = gt.tricount_prep_csr(A)
    rng = np.random.default_rng(3)
    out = []
    for pkg in (gt, gb):
        T = pkg.Type.udt("tri", n=pkg.INT64, w=pkg.FP64)
        sr, mon = _tri_semiring(pkg, T)
        rng = np.random.default_rng(3)
        LU = []
        for X_ in (Lc, Uc):
            i_, j_, _ = X_.extractTuples()
            vals = {"n": np.ones(len(i_), np.int64),
                    "w": rng.uniform(0.5, 1.5, len(i_))}
            if pkg is gt:
                LU.append(gt.csr_from_coo(i_, j_, vals, n, n, type=T,
                                          sum_duplicates=False,
                                          device="cpu"))
            else:
                LU.append(jsp.CsrMatrix.from_coo(i_, j_, vals, n, n,
                                                 type=T,
                                                 sum_duplicates=False))
        e = {"n": np.zeros(0, np.int64), "w": np.zeros(0)}
        z = np.zeros(0, np.int64)
        C0 = (gt.csr_from_coo(z, z, e, n, n, type=T, device="cpu")
              if pkg is gt else jsp.CsrMatrix.from_coo(z, z, e, n, n,
                                                       type=T))
        C = pkg.mxm(C0, LU[0], None, sr, LU[0], LU[1],
                    pkg.Descriptor(tran1=True, mask_structure=True))
        out.append((C, LU))
    (Ct, LUt), (Cj, _) = out
    It, Jt, Xt = Ct.extractTuples()
    Ij, Jj, Xj = Cj.extractTuples()
    assert np.array_equal(It, Ij) and np.array_equal(Jt, Jj)
    assert np.array_equal(Xt["n"], np.asarray(Xj["n"]))
    np.testing.assert_allclose(Xt["w"], np.asarray(Xj["w"]), rtol=1e-12)
    assert int(Xt["n"].sum()) == int(gt.tricount_esc(Lc, Uc))
    # the w field: plus_times[FP64] on the same values
    def fp64(X_):
        return gt.CsrMatrix(X_.indptr, X_.indices, X_.rowids,
                            X_.values["w"], X_.nvals, X_.nrows, X_.ncols,
                            gt.FP64)
    Lw, Uw = fp64(LUt[0]), fp64(LUt[1])
    Cw = gt.mxm(gt.csr_from_coo([], [], np.zeros(0), n, n, device="cpu"),
                Lw, None, gt.semiring.plus_times[gt.FP64], Lw, Uw,
                gt.Descriptor(tran1=True, mask_structure=True))
    _, _, Xw = Cw.extractTuples()
    np.testing.assert_allclose(Xt["w"], Xw, rtol=1e-12)


def test_rmat_facade_matches_jax(tmp_path):
    """The user-facing layer on R-MAT 10 (the thirteenth slice), against
    the JAX package: the masked product through the facade,
    ``GrB_mxm(C<M>, GxB_PLUS_TIMES_FP32, L, U)`` with bench.py's values,
    bit-equal to the port's ``mxm`` on the same inputs and within rtol
    2e-5, atol 2e-6 of the JAX facade's (reassociation); the
    ``tri_demo`` flow through ``grb`` names (``GxB_select``,
    ``GrB_mxm(C<L>, GxB_PLUS_TIMES_UINT32, L, U')``, ``GrB_reduce``:
    exact, equal to ``tricount_esc``); ``write_triplets`` bytes and the
    ``.npz`` round trip of L; ``check`` and the ``fprint`` text."""
    import io as _io
    from graphblas_tpu import grb as jgrb
    from graphblas_tpu import io as jio
    from graphblas_tpu_torch import grb
    from graphblas_tpu_torch import io as tio
    (Lt, Ut), (Lj, Uj) = _rmat_both(10)
    n = Lt.nrows
    rng = np.random.default_rng(3)
    (Lvt, Lvj), (Uvt, Uvj), (Mvt, Mvj) = (_with_values(rng, a, b) for a, b
                                          in ((Lt, Lj), (Ut, Uj), (Lt, Lj)))
    e = np.zeros(0, np.int64)

    def empty(t):
        return gt.csr_from_coo(e, e, np.zeros(0, t.dtype), n, n, type=t,
                               device="cpu")

    def jempty(t):
        return jsp.CsrMatrix.from_coo(e, e, np.zeros(0, t.dtype), n, n,
                                      type=t)
    # 1. the masked product through the facade
    Cf = grb.GrB_mxm(empty(gt.FP32), Mvt, None, grb.GxB_PLUS_TIMES_FP32,
                     Lvt, Uvt, grb.GrB_Descriptor_new())
    Cd = gt.mxm(empty(gt.FP32), Mvt, None, gt.semiring.plus_times[gt.FP32],
                Lvt, Uvt)
    assert Cf.nvals == Cd.nvals > 0
    for a, b in zip(Cf.extractTuples(), Cd.extractTuples()):
        assert np.array_equal(a, b)
    Cj = jgrb.GrB_mxm(jempty(gb.FP32), Mvj, None, jgrb.GxB_PLUS_TIMES_FP32,
                      Lvj, Uvj, jgrb.GrB_Descriptor_new())
    It, Jt, Xt = Cf.extractTuples()
    Ij, Jj, Xj = Cj.extractTuples()
    assert np.array_equal(It, np.asarray(Ij))
    assert np.array_equal(Jt, np.asarray(Jj))
    np.testing.assert_allclose(Xt, np.asarray(Xj), rtol=2e-5, atol=2e-6)
    # 2. the tri_demo flow through grb names
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(10, 16, seed=7), n)
    X = np.ones(len(I), bool)
    counts = []
    for g, mk, A in ((grb, empty, gt.csr_from_coo(
            I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
            device="cpu")), (jgrb, jempty, jsp.CsrMatrix.from_coo(
                I, J, X, n, n, type=gb.BOOL, sum_duplicates=False))):
        L = g.GxB_select(mk(g.GrB_BOOL), None, None, g.GxB_TRIL, A, -1)
        U = g.GxB_select(mk(g.GrB_BOOL), None, None, g.GxB_TRIU, A, 1)
        d = g.GrB_Descriptor_set(g.GrB_Descriptor_new(), g.GrB_INP1,
                                 g.GrB_TRAN)
        C = g.GrB_mxm(mk(g.GrB_UINT32), L, None, g.GxB_PLUS_TIMES_UINT32,
                      L, U, d)
        counts.append(int(g.GrB_reduce(None, g.GxB_PLUS_INT64_MONOID, C)))
    assert counts[0] == counts[1] == gt.tricount_esc(Lt, Ut) > 0
    # 3. IO: triplet bytes, read back, the .npz round trip
    tio.write_triplets(tmp_path / "t.tsv", Lvt)
    jio.write_triplets(tmp_path / "j.tsv", Lvj)
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()
    Ir, Jr, Xr = tio.read_triplets(str(tmp_path / "t.tsv"))
    Il, Jl, Xl = Lvt.extractTuples()
    assert np.array_equal(Ir, Il) and np.array_equal(Jr, Jl)
    assert np.array_equal(Xr.astype(np.float32), Xl)
    tio.save_matrix(tmp_path / "l.npz", Lvt)
    Lb = tio.load_matrix(tmp_path / "l.npz", as_csr=True, device="cpu")
    for a, b in zip(Lb.extractTuples(), Lvt.extractTuples()):
        assert np.array_equal(a, b)
    Lj2 = jio.load_matrix(tmp_path / "l.npz", as_csr=True)
    for a, b in zip(Lj2.extractTuples(), Lvt.extractTuples()):
        assert np.array_equal(np.asarray(a), b)
    # 4. check and fprint
    assert gt.check(Lvt) and gt.check(Lb)
    for level in (gt.SUMMARY, gt.SHORT):
        bt, bj = _io.StringIO(), _io.StringIO()
        gt.fprint(Lvt, "L", level, bt)
        gb.fprint(Lvj, "L", level, bj)
        assert bt.getvalue() == bj.getvalue()
    assert bt.getvalue().count("\n    (") == 30
