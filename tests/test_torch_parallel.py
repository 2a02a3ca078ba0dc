"""PyTorch port: the distributed layer's bitmap blocks and sharded CSR
(``graphblas_tpu_torch.parallel``) against the JAX package's
``graphblas_tpu.parallel``, case for case with ``test_parallel.py``.

The port's side of every case runs in one gloo world of 4 CPU ranks
(a (2, 2) mesh for the k-step SUMMA, (1, 4) for the panel form),
started once for the module by ``run_world``; the ranks import only
torch and the port (``parallel/parity.py`` holds their side).  The JAX
side runs here on its 8-device CPU mesh (``conftest.py``).  Inputs are
numpy arrays from fixed seeds.  Patterns, integers, booleans and BFS
levels must be equal; float values agree within rtol 1e-5, atol 1e-6
(float32) and 1e-12 (float64).

The last cases hold the port's cross-rank combines to its own fold
rules (LOR/LAND over INT8/UINT8, NaN under MIN/MAX, UINT64 at or above
2^63 under MAX, complex MIN) against its single-device result, and pin
the JAX package's distributed values where they differ (ROADMAP.md,
"Known in the reference").
"""

import jax
import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import parallel as jpar
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core.semirings import semiring as jsemiring

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.parallel import run_world
from graphblas_tpu_torch.parallel.parity import run_cases

TOL = {np.dtype(np.float32): dict(rtol=1e-5, atol=1e-6),
       np.dtype(np.float64): dict(rtol=1e-12, atol=1e-12)}


def _graph(n, p, seed, symmetric=True):
    rng = np.random.default_rng(seed)
    Ap = rng.random((n, n)) < p
    np.fill_diagonal(Ap, False)
    if symmetric:
        Ap = Ap | Ap.T
    return Ap


def _bm(Ap):
    """(values, pattern, type) of an FP64 0/1 graph."""
    return (Ap.astype(np.float64), Ap, "FP64")


def _jm(vals, pat, t):
    return gb.Matrix.from_dense(vals, getattr(gb, t), pattern=pat)


def _rand_pair(n, density, seed):
    rng = np.random.default_rng(seed)
    Ap = rng.random((n, n)) < density
    Bp = rng.random((n, n)) < density
    Av = np.where(Ap, rng.normal(size=(n, n)), 0.0)
    Bv = np.where(Bp, rng.normal(size=(n, n)), 0.0)
    return Ap, Av, Bp, Bv


def _coo(pat, vals, t):
    I, J = np.nonzero(pat)
    return (I, J, vals[I, J], pat.shape[0], pat.shape[1], t)


# -- inputs, shared by both sides ---------------------------------------------

G37 = _graph(37, 0.2, 0)
G40 = _graph(40, 0.2, 1)
G24 = _graph(24, 0.3, 2)
G32 = _graph(32, 0.25, 3)
S4, S5 = _graph(32, 0.25, 4), _graph(32, 0.25, 5)
K14, K15 = _graph(40, 0.3, 14), _graph(40, 0.3, 15)
B16, B17, B18 = _graph(48, 0.2, 16), _graph(48, 0.2, 17), _graph(48, 0.4, 18)
G50 = _graph(50, 0.08, 6)
G40b = _graph(40, 0.15, 7)
G48 = _graph(48, 0.2, 8)
G16 = _graph(16, 0.3, 9)
CV16 = np.random.default_rng(0).random((16, 16))
G53 = _graph(53, 0.15, 20)
X53 = np.random.default_rng(0).random(53).astype(np.float32)
G40c = _graph(40, 0.15, 21)
G60 = _graph(60, 0.07, 22)
G37b = _graph(37, 0.2, 30)


def _valued_mask_inputs():
    n = 16
    rng = np.random.default_rng(31)
    A = _graph(n, 0.4, 31)
    Mv = rng.integers(0, 2, (n, n)).astype(np.float64)
    B = np.random.default_rng(32).random((n, 24))
    return A, Mv, B


VA, VMv, VB = _valued_mask_inputs()

SPGEMM_SEMIRINGS = [("plus_times", "FP64"), ("min_plus", "FP64"),
                    ("max_times", "FP64"), ("plus_pair", "INT32"),
                    ("lor_land", "BOOL"), ("lxor_land", "BOOL")]


def _spgemm_inputs(t):
    n = 96
    Ap, Av, Bp, Bv = _rand_pair(n, 0.12, 11)
    Mp = np.random.default_rng(12).random((n, n)) < 0.3
    if t == "BOOL":
        Av, Bv = Ap, Bp
    elif t == "INT32":
        Av = (Av * 5).astype(np.int32)
        Bv = (Bv * 5).astype(np.int32)
    return (_coo(Ap, Av, t), _coo(Bp, Bv, t),
            _coo(Mp, np.ones(Mp.shape, bool), "BOOL"))


def _unmasked_inputs():
    Ap, Av, Bp, Bv = _rand_pair(80, 0.1, 13)
    return _coo(Ap, Av, "FP64"), _coo(Bp, Bv, "FP64")


def _udt_vector_inputs():
    n = 64
    rng = np.random.default_rng(15)
    Ap = rng.random((n, n)) < 0.15
    np.fill_diagonal(Ap, False)
    I, J = np.nonzero(Ap.T)
    deg = Ap.sum(1).astype(np.float64)
    return ((I, J, np.ones(len(I), bool), n, n, "BOOL"),
            np.full(n, 1.0 / n), 1.0 / np.maximum(deg, 1.0))


def _udt_matrix_inputs():
    n = 48
    rng = np.random.default_rng(16)
    Ap = rng.random((n, n)) < 0.2
    I, J = np.nonzero(Ap)
    va, vb = rng.normal(size=len(I)), rng.normal(size=len(I))
    return I, J, va, vb, n, rng.normal(size=n)


# -- the trap inputs (n = 8: rows 0 and 4 lie on different ranks) ----------

def _trap_matrix(t, entries, n=8):
    dt = np.dtype(getattr(gt, t).dtype)
    vals = np.zeros((n, n), dt)
    pat = np.zeros((n, n), bool)
    for (i, j), x in entries.items():
        vals[i, j] = x
        pat[i, j] = True
    return vals, pat, t


TRAPS = {
    "lor_int8": (("lor_second", "INT8"), _trap_matrix(
        "INT8", {(0, 0): -1, (4, 0): -2, (1, 1): 5, (5, 1): 0,
                 (2, 2): -1})),
    "land_uint8": (("land_second", "UINT8"), _trap_matrix(
        "UINT8", {(0, 0): 2, (4, 0): 3, (1, 1): 5, (5, 1): 0,
                  (2, 2): 255})),
    "nan_min": (("min_plus", "FP64"), _trap_matrix(
        "FP64", {(0, 0): np.nan, (4, 0): 5.0, (1, 1): np.nan,
                 (2, 2): -3.0, (6, 2): np.nan})),
    "nan_max": (("max_plus", "FP64"), _trap_matrix(
        "FP64", {(0, 0): np.nan, (4, 0): 5.0, (1, 1): np.nan,
                 (2, 2): -3.0, (6, 2): np.nan})),
    "uint64_max": (("max_second", "UINT64"), _trap_matrix(
        "UINT64", {(0, 0): 2 ** 63 + 5, (4, 0): 7, (1, 1): 2 ** 64 - 1,
                   (5, 1): 2 ** 63, (2, 2): 3, (6, 2): 2 ** 63 - 1})),
    "fc64_min": (("min_plus", "FC64"), _trap_matrix(
        "FC64", {(0, 0): 1 + 2j, (4, 0): 1 - 2j, (1, 1): np.nan + 1j,
                 (5, 1): 3 + 0j, (2, 2): -1j})),
}


def _trap_u(t, n=8):
    dt = np.dtype(getattr(gt, t).dtype)
    return np.ones(n, dt), np.ones(n, bool), t


def _cases():
    c = [
        ("roundtrip", "roundtrip", dict(vals=G37.astype(np.float64),
                                        pat=G37, t="FP64")),
        ("vxm", "vxm", dict(sr=("plus_times", "FP64"), avals=_bm(G40)[0],
                            apat=G40, at="FP64",
                            uvals=np.arange(40, dtype=np.float64),
                            upat=np.ones(40, bool), ut="FP64")),
        ("vxm_bool", "vxm", dict(
            sr=("lor_land", "BOOL"), avals=G24, apat=G24, at="BOOL",
            uvals=np.eye(24, dtype=bool)[3], upat=np.eye(24, dtype=bool)[3],
            ut="BOOL")),
        ("mxm_masked", "mxm", dict(sr=("plus_times", "FP64"), a=_bm(G32),
                                   b=_bm(G32), m=_bm(G32))),
        ("summa", "summa", dict(sr=("plus_times", "FP64"), a=_bm(S4),
                                b=_bm(S5), shape=(1, 4))),
        ("bshard", "mxm_bshard", dict(sr=("plus_times", "FP64"),
                                      a=_bm(B16), b=_bm(B17), m=_bm(B18))),
        ("bshard_ref", "mxm", dict(sr=("plus_times", "FP64"), a=_bm(B16),
                                   b=_bm(B17), m=_bm(B18))),
        ("bfs", "bfs", dict(pat=G50, s=0)),
        ("pagerank", "pagerank", dict(pat=G40b, iters=20)),
        ("tricount", "tricount", dict(pat=G48)),
        ("steps", "steps", dict(pat=G16, cv=CV16)),
        ("csr_mxv", "csr_mxv", dict(a=_bm(G53), x=X53, bitmap=True)),
        ("csr_pagerank", "csr_pagerank", dict(pat=G40c, iters=15)),
        ("csr_bfs", "csr_bfs", dict(pat=G60, s=0)),
        ("pagerank_37", "pagerank", dict(pat=G37b, iters=20)),
        ("valued_mask", "mxm", dict(
            sr=("plus_times", "FP64"), a=_bm(VA),
            b=_bm(VA), m=(VMv, np.ones((16, 16), bool), "FP64"))),
        ("rectangular", "mxm", dict(
            sr=("plus_times", "FP64"), a=_bm(VA),
            b=(VB, np.ones(VB.shape, bool), "FP64"), b_spec=(None, None))),
        ("unmasked", "spgemm", dict(sr=("plus_times", "FP64"),
                                    a=_unmasked_inputs()[0],
                                    b=_unmasked_inputs()[1])),
        ("udt_vector", "csr_mxv_udt_vector", dict(
            a=_udt_vector_inputs()[0], rank=_udt_vector_inputs()[1],
            invdegree=_udt_vector_inputs()[2])),
        ("udt_matrix", "csr_udt_matrix_values", dict(
            zip(("I", "J", "va", "vb", "n", "x"), _udt_matrix_inputs()))),
        ("dryrun", "dryrun", dict(n_devices=4)),
        ("no_card", "no_card", {}),
        ("meshes", "meshes_and_specs", {}),
    ]
    iso = np.zeros((16, 16))
    iso[0, 5] = 5.0
    c.append(("min_plus_identity", "vxm", dict(
        sr=("min_plus", "FP64"), avals=iso, apat=iso != 0, at="FP64",
        uvals=np.ones(16), upat=np.ones(16, bool), ut="FP64")))
    for a, b in ((K14, K15),):
        for srname in ("plus_times", "min_plus"):
            c.append((f"kstep_{srname}", "summa", dict(
                sr=(srname, "FP64"), a=_bm(a), b=_bm(b), shape=(2, 2))))
    for sr in SPGEMM_SEMIRINGS:
        a, b, m = _spgemm_inputs(sr[1])
        c.append((f"masked_{sr[0]}_{sr[1]}", "masked_spgemm",
                  dict(sr=sr, a=a, b=b, m=m)))
    for name, (sr, (vals, pat, t)) in TRAPS.items():
        uv, up, ut = _trap_u(t)
        c.append((f"trap_vxm_{name}", "vxm", dict(
            sr=sr, avals=vals, apat=pat, at=t, uvals=uv, upat=up, ut=ut)))
    return c


@pytest.fixture(scope="module")
def port():
    return run_world(run_cases, 4, "gloo", "cpu", _cases(), "cpu")


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should give 8 cpu devices"
    return jpar.make_mesh(8)


def _ok(res):
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


def _same_bitmap(got, want: "gb.Matrix"):
    vals, pat = _ok(got)
    wpat = want.pattern_np()
    wvals = want.to_dense()
    assert np.array_equal(pat, wpat)
    dt = np.asarray(wvals).dtype
    if dt.kind == "f":
        np.testing.assert_allclose(vals[pat], np.asarray(wvals)[pat],
                                   **TOL[dt])
    else:
        assert np.array_equal(vals[pat], np.asarray(wvals)[pat])


def test_distribute_collect_roundtrip(port, mesh):
    A = _jm(*_bm(G37))
    want = jpar.collect(jpar.distribute(A, mesh))
    _same_bitmap(port["roundtrip"], want)
    assert np.array_equal(port["roundtrip"][0], G37.astype(np.float64))


def test_dist_vxm_matches_local(port, mesh):
    A = _jm(*_bm(G40))
    u = gb.Vector.from_dense(np.arange(40, dtype=np.float64))
    sr = jsemiring.plus_times[gb.FP64]
    want = gb.vxm(gb.Vector.new(gb.FP64, 40), None, None, sr, u, A)
    jw = jpar.collect(jpar.dist_vxm(
        sr, jpar.distribute(u, mesh, spec=jpar.P("i")),
        jpar.distribute(A, mesh)))
    _same_bitmap(port["vxm"], want)
    _same_bitmap(port["vxm"], jw)


def test_dist_vxm_bool_lor_land(port, mesh):
    A = _jm(*_bm(G24))
    Ab = gb.Matrix(A.pattern, A.pattern, gb.BOOL)
    q = np.eye(24, dtype=bool)[3]
    u = gb.Vector.from_dense(q, gb.BOOL, pattern=q)
    sr = jsemiring.lor_land[gb.BOOL]
    got = jpar.collect(jpar.dist_vxm(
        sr, jpar.distribute(u, mesh, spec=jpar.P("i")),
        jpar.distribute(Ab, mesh)))
    vals, pat = _ok(port["vxm_bool"])
    assert np.array_equal(vals & pat, got.to_dense() != 0)
    assert np.array_equal(pat, got.pattern_np())


def test_dist_mxm_masked(port, mesh):
    A = _jm(*_bm(G32))
    want = gb.mxm(gb.Matrix.new(gb.FP64, 32, 32), A, None,
                  jsemiring.plus_times[gb.FP64], A, A)
    D = jpar.distribute(A, mesh)
    jd = jpar.collect(jpar.dist_mxm(jsemiring.plus_times[gb.FP64], D, D,
                                    M=D))
    _same_bitmap(port["mxm_masked"], want)
    _same_bitmap(port["mxm_masked"], jd)


def test_dist_mxm_summa(port):
    A, B = _jm(*_bm(S4)), _jm(*_bm(S5))
    mesh2d = jpar.make_mesh(8, shape=(4, 2), axis_names=("i", "j"))
    sr = jsemiring.plus_times[gb.FP64]
    want = gb.mxm(gb.Matrix.new(gb.FP64, 32, 32), None, None, sr, A, B)
    jd = jpar.collect(jpar.dist_mxm_summa(
        sr, jpar.distribute(A, mesh2d), jpar.distribute(B, mesh2d)))
    _same_bitmap(port["summa"], want)
    _same_bitmap(port["summa"], jd)


@pytest.mark.parametrize("srname", ["plus_times", "min_plus"])
def test_dist_mxm_summa_kstep(port, srname):
    A, B = _jm(*_bm(K14)), _jm(*_bm(K15))
    mesh_sq = jpar.make_mesh(4, shape=(2, 2), axis_names=("i", "j"))
    sr = jsemiring[srname][gb.FP64]
    want = gb.mxm(gb.Matrix.new(gb.FP64, 40, 40), None, None, sr, A, B)
    jd = jpar.collect(jpar.dist_mxm_summa(
        sr, jpar.distribute(A, mesh_sq), jpar.distribute(B, mesh_sq)))
    _same_bitmap(port[f"kstep_{srname}"], want)
    _same_bitmap(port[f"kstep_{srname}"], jd)


def test_dist_mxm_bshard_matches_replicated(port, mesh):
    sr = jsemiring.plus_times[gb.FP64]
    DA, DB, DM = (jpar.distribute(_jm(*_bm(x)), mesh)
                  for x in (B16, B17, B18))
    jd = jpar.collect(jpar.dist_mxm_bshard(sr, DA, DB, M=DM))
    _same_bitmap(port["bshard"], jd)
    _same_bitmap(port["bshard_ref"], jd)


def test_dist_bfs(port, mesh):
    from graphblas_tpu import models
    A = _jm(*_bm(G50))
    got = _ok(port["bfs"])
    assert np.array_equal(got, models.bfs_jit(A, 0))
    assert np.array_equal(got, jpar.dist_bfs(A, 0, mesh))


def test_dist_pagerank(port, mesh):
    from graphblas_tpu import models
    A = _jm(*_bm(G40b))
    got = _ok(port["pagerank"])
    np.testing.assert_allclose(got, models.pagerank_jit(A, iters=20),
                               **TOL[np.dtype(np.float64)])
    np.testing.assert_allclose(got, jpar.dist_pagerank(A, 20, mesh),
                               **TOL[np.dtype(np.float64)])


def test_dist_tricount(port, mesh):
    Ap = G48.astype(np.int64)
    want = int(((Ap @ Ap) * Ap).sum()) // 6
    assert _ok(port["tricount"]) == want == jpar.dist_tricount(
        _jm(*_bm(G48)), mesh)


def test_step_functions(port, mesh):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    n = 16
    Apd = jax.device_put(_jm(*_bm(G16)).pattern,
                         NamedSharding(mesh, jpar.P("i", None)))
    v = jnp.zeros((n,), jnp.int32)
    q = jnp.zeros((n,), bool).at[0].set(True)
    v2, q2 = jpar.bfs_step_sharded(mesh)(v, q, Apd, jnp.int32(1))
    Cv = jax.device_put(jnp.asarray(CV16),
                        NamedSharding(mesh, jpar.P("i", None)))
    r2 = jpar.pagerank_step_sharded(mesh)(Cv, jnp.full((n,), 1.0 / n),
                                          jnp.asarray(0.15 / n))
    pv, pq, pr = _ok(port["steps"])
    assert pv[0] == 1
    assert np.array_equal(pv, np.asarray(v2))
    assert np.array_equal(pq, np.asarray(q2))
    np.testing.assert_allclose(pr, np.asarray(r2),
                               **TOL[np.dtype(np.float64)])


def test_dist_csr_mxv(port, mesh):
    A = _jm(*_bm(G53))
    y = _ok(port["csr_mxv"])
    want = np.asarray(jpar.dist_csr_mxv(jpar.dist_csr_from_matrix(A, mesh),
                                        X53))
    np.testing.assert_allclose(y, want, **TOL[np.dtype(np.float32)])
    np.testing.assert_allclose(y, G53.astype(np.float64) @ X53, rtol=1e-5)


def test_dist_csr_pagerank(port, mesh):
    from graphblas_tpu import models
    A = _jm(*_bm(G40c))
    got = _ok(port["csr_pagerank"])
    np.testing.assert_allclose(got, jpar.dist_csr_pagerank(A, 15, mesh),
                               **TOL[np.dtype(np.float32)])
    assert np.allclose(got, models.pagerank_jit(A, iters=15), atol=1e-5)


def test_dist_csr_bfs(port, mesh):
    from graphblas_tpu import models
    A = _jm(*_bm(G60))
    got = _ok(port["csr_bfs"])
    assert np.array_equal(got, models.bfs_jit(A, 0))
    assert np.array_equal(got, jpar.dist_csr_bfs(A, 0, mesh))


def test_dist_vxm_min_plus_identity_combine(port, mesh):
    # a column whose only contribution lives on one rank must not be
    # poisoned by the other ranks' absent partials
    vals, pat = _ok(port["min_plus_identity"])
    assert pat[5] and vals[5] == 6.0
    iso = np.zeros((16, 16))
    iso[0, 5] = 5.0
    A = gb.Matrix.from_dense(iso, gb.FP64, pattern=iso != 0)
    u = gb.Vector.from_dense(np.full(16, 1.0))
    sr = jsemiring.min_plus[gb.FP64]
    jd = jpar.collect(jpar.dist_vxm(sr, jpar.distribute(u, mesh,
                                                        spec=jpar.P("i")),
                                    jpar.distribute(A, mesh)))
    _same_bitmap(port["min_plus_identity"], jd)


def test_dist_pagerank_nondivisible_n(port, mesh):
    from graphblas_tpu import models
    A = _jm(*_bm(G37b))
    got = _ok(port["pagerank_37"])
    np.testing.assert_allclose(got, models.pagerank_jit(A, iters=20),
                               **TOL[np.dtype(np.float64)])
    np.testing.assert_allclose(got, jpar.dist_pagerank(A, 20, mesh),
                               **TOL[np.dtype(np.float64)])


def test_dist_mxm_valued_mask_and_rectangular(port, mesh):
    A = _jm(*_bm(VA))
    M = gb.Matrix.from_dense(VMv, gb.FP64, pattern=np.ones((16, 16), bool))
    sr = jsemiring.plus_times[gb.FP64]
    want = gb.mxm(gb.Matrix.new(gb.FP64, 16, 16), M, None, sr, A, A)
    D = jpar.distribute(A, mesh)
    jd = jpar.collect(jpar.dist_mxm(sr, D, D, M=jpar.distribute(M, mesh)))
    _same_bitmap(port["valued_mask"], want)
    _same_bitmap(port["valued_mask"], jd)
    B = gb.Matrix.from_dense(VB)
    jr = jpar.collect(jpar.dist_mxm(
        sr, D, jpar.distribute(B, mesh, spec=jpar.P(None, None))))
    assert port["rectangular"][0].shape == (16, 24)
    _same_bitmap(port["rectangular"], jr)


@pytest.mark.parametrize("srname,ty", SPGEMM_SEMIRINGS)
def test_dist_masked_spgemm_semirings(port, mesh, srname, ty):
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.esc import csr_spgemm
    a, b, m = _spgemm_inputs(ty)
    A, B, M = (CsrMatrix.from_coo(*x[:5], type=getattr(gb, x[5]))
               for x in (a, b, m))
    sr = jsemiring[srname][getattr(gb, ty)]
    want = csr_spgemm(sr, A, B, mask=M)
    jd = jpar.dist_masked_spgemm(sr, A, B, M, mesh=mesh)
    gI, gJ, gX = _ok(port[f"masked_{srname}_{ty}"])
    for ref in (want, jd):
        wI, wJ, wX = ref.extractTuples()
        assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
        wX = np.asarray(wX)
        if wX.dtype.kind == "f":
            np.testing.assert_allclose(gX, wX, **TOL[wX.dtype])
        else:
            assert np.array_equal(np.asarray(gX), wX)


def test_dist_spgemm_unmasked(port, mesh):
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.esc import csr_spgemm
    a, b = _unmasked_inputs()
    A, B = (CsrMatrix.from_coo(*x[:5], type=gb.FP64) for x in (a, b))
    sr = jsemiring.plus_times[gb.FP64]
    gI, gJ, gX = _ok(port["unmasked"])
    for ref in (csr_spgemm(sr, A, B), jpar.dist_spgemm(sr, A, B, mesh=mesh)):
        wI, wJ, wX = ref.extractTuples()
        assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
        np.testing.assert_allclose(gX, np.asarray(wX),
                                   **TOL[np.dtype(np.float64)])


def test_dist_csr_mxv_udt_vector(port, mesh):
    """One PageRank-semiring step (struct values) over the ranks against
    the JAX package's distributed and single-device UDT SpMV."""
    import jax.numpy as jnp
    from graphblas_tpu.core.ops import BinaryOp
    from graphblas_tpu.core.semirings import semiring_new
    from graphblas_tpu.models.pagerank import PAGERANK_TYPE, pagerank_ops
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.spmv import csr_mxv
    (I, J, X, n, _, _), rank, invdeg = _udt_vector_inputs()
    AT = CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL)
    pr_mult, _, pr_monoid, _ = pagerank_ops()
    flip = BinaryOp("PR_FLIP", lambda a, x: pr_mult.fn(x, a),
                    PAGERANK_TYPE, gb.BOOL, PAGERANK_TYPE)
    sr = semiring_new(pr_monoid, flip)
    r = {"rank": jnp.asarray(rank), "invdegree": jnp.asarray(invdeg)}
    want, _ = csr_mxv(sr, AT, r)
    jd = jpar.dist_csr_mxv(jpar.dist_csr_from_matrix(AT, mesh), r, sr)
    got = _ok(port["udt_vector"])
    for ref in (want, jd):
        for f in ("rank", "invdegree"):
            np.testing.assert_allclose(got[f], np.asarray(ref[f]),
                                       **TOL[np.dtype(np.float64)])


def test_dist_csr_udt_matrix_values(port, mesh):
    import jax.numpy as jnp
    from graphblas_tpu.core.monoids import monoid_new
    from graphblas_tpu.core.ops import BinaryOp
    from graphblas_tpu.core.semirings import semiring_new
    from graphblas_tpu.core.types import Type
    from graphblas_tpu.sparse import CsrMatrix
    from graphblas_tpu.sparse.spmv import csr_mxv
    I, J, va, vb, n, x = _udt_matrix_inputs()
    W = Type.udt("wt", a=gb.FP64, b=gb.FP64)
    A = CsrMatrix.from_coo(I, J, {"a": va, "b": vb}, n, n, type=W,
                           sum_duplicates=False)
    mult = BinaryOp("WMULT", lambda e, x: {
        "a": e["a"] * x, "b": e["b"] + x}, W, W, gb.FP64)
    add = BinaryOp("WADD", lambda x, y: {
        "a": x["a"] + y["a"], "b": jnp.maximum(x["b"], y["b"])}, W, W, W)
    sr = semiring_new(monoid_new(add, {"a": 0.0, "b": -np.inf}), mult)
    want, _ = csr_mxv(sr, A, jnp.asarray(x))
    jd = jpar.dist_csr_mxv(jpar.dist_csr_from_matrix(A, mesh),
                           jnp.asarray(x), sr)
    got = _ok(port["udt_matrix"])
    for ref in (want, jd):
        for f in ("a", "b"):
            np.testing.assert_allclose(got[f], np.asarray(ref[f]),
                                       **TOL[np.dtype(np.float64)])


def test_dryrun_lines_match_jax(port, capsys):
    """Every step of the JAX ``dryrun_multichip`` runs on the ranks and
    prints the same line (the census line differs by design: the JAX
    line holds the HLO census)."""
    import __graft_entry__ as graft
    graft.dryrun_multichip(8)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("dryrun:")]
    lines = _ok(port["dryrun"])
    assert lines[:-1] == jax_lines[:-1]
    assert lines[-1].startswith("dryrun: ring schedule collectives: ")
    assert "'ppermute': {'calls': 9," in lines[-1]


def test_make_mesh_and_shardings(port):
    """The default meshes factor the world as JAX's factor its devices
    (4 ranks: (4,) and (2, 2)); the placement specs are JAX's."""
    got = _ok(port["meshes"])
    m1 = jpar.make_mesh(4)
    m2 = jpar.make_mesh(4, axis_names=("i", "j"))
    assert got["shape1"] == dict(m1.shape)
    assert got["shape2"] == dict(m2.shape) == {"i": 2, "j": 2}
    assert got["devices2"] == m2.devices.shape
    assert got["row"] == tuple(jpar.row_sharding(m1).spec)
    assert got["row3"] == tuple(jpar.row_sharding(m1, 3).spec)
    assert got["rep"] == tuple(jpar.replicated(m2).spec)
    assert "every rank of the world takes part" in got["wrong"]


def test_make_mesh_without_a_card_raises(port):
    """Without ``device="cpu"`` a rank's mesh goes to the card, and
    without one make_mesh raises rather than carry on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    assert "no CUDA device" in port["no_card"]["error"]


def test_nccl_with_more_ranks_than_gpus_raises():
    import torch
    from graphblas_tpu_torch.parallel.parity import run_cases as fn
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="nccl needs one GPU per rank"):
        run_world(fn, n + 1, "nccl", "cuda", [], "cuda")


# -- the port's combine rules, and the JAX package's values pinned ----------

def _port_single(name):
    """The port's single-device vxm of the trap case (u = ones)."""
    sr, (vals, pat, t) = TRAPS[name]
    uv, up, ut = _trap_u(t)
    T = getattr(gt, t)
    A = gt.Matrix.from_dense(vals, T, pattern=pat, device="cpu")
    u = gt.Vector.from_dense(uv, T, pattern=up, device="cpu")
    s = gt.semiring[sr[0]][T]
    w = gt.vxm(gt.Vector.new(s.ztype, 8, device="cpu"), None, None, s, u, A)
    return w.to_dense(), w.pattern_np()


def _jax_dist(name, mesh):
    sr, (vals, pat, t) = TRAPS[name]
    uv, up, ut = _trap_u(t)
    T = getattr(gb, t)
    A = gb.Matrix.from_dense(vals, T, pattern=pat)
    u = gb.Vector.from_dense(uv, T, pattern=up)
    w = jpar.collect(jpar.dist_vxm(
        jsemiring[sr[0]][T], jpar.distribute(u, mesh, spec=jpar.P("i")),
        jpar.distribute(A, mesh)))
    return w.to_dense()[:3]


#: the JAX package's distributed vxm on the trap inputs, columns 0-2.
#: Its bitmap block product already folds LOR/LAND to 0/1 and drops NaN
#: terms, so its pmax/pmin combine agrees with the port on these; its
#: complex MIN combine does not compile (pmin of c128).  The sharded-CSR
#: forms differ (test_torch_dist_csr.py).
JAX_DIST = {
    "lor_int8": [1, 1, 1],
    "land_uint8": [1, 0, 1],
    "nan_min": [6.0, np.inf, -2.0],
    "nan_max": [6.0, -np.inf, -2.0],
    "uint64_max": [2 ** 63 + 5, 2 ** 64 - 1, 2 ** 63 - 1],
    "fc64_min": None,
}


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_dist_vxm_combine_follows_the_port(port, mesh, name):
    vals, pat = _ok(port[f"trap_vxm_{name}"])
    wv, wp = _port_single(name)
    assert np.array_equal(pat, wp)
    assert np.array_equal(np.asarray(vals)[pat], np.asarray(wv)[wp],
                          equal_nan=vals.dtype.kind in "fc")
    if JAX_DIST[name] is None:
        with pytest.raises(Exception, match="Unsupported reduction"):
            _jax_dist(name, mesh)
    else:
        np.testing.assert_array_equal(
            _jax_dist(name, mesh),
            np.asarray(JAX_DIST[name], dtype=np.asarray(wv).dtype))


@pytest.fixture
def world1(tmp_path):
    """A gloo world of one rank in this process (the calling rank of
    ``convert.from_jax``)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield gt.parallel.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_from_jax_dist_containers(world1, mesh):
    """convert.from_jax collects a JAX DistMatrix, DistVector and
    DistCsr and re-shards each over the port's mesh."""
    from graphblas_tpu_torch import convert
    from graphblas_tpu_torch.parallel import collect, dist_csr_mxv
    A = _jm(*_bm(G37))
    DA = jpar.distribute(A, mesh)
    PA = convert.from_jax(DA, mesh=world1)
    assert PA.spec == gt.parallel.P("i", None)
    _same_bitmap((collect(PA).to_dense(), collect(PA).pattern_np()),
                 jpar.collect(DA))
    u = gb.Vector.from_dense(np.arange(37, dtype=np.float64))
    Du = jpar.distribute(u, mesh, spec=jpar.P("i"))
    Pu = convert.from_jax(Du, mesh=world1)
    assert np.array_equal(collect(Pu).to_dense(), np.arange(37.0))
    # the vxm form (A' slabs, bool values staged as uint8 in the JAX
    # slabs) and flop-balanced slabs (boundaries of 8 JAX ranks do not
    # fit one port rank: uniform slabs); G53 is symmetric, so both give
    # y = G53 x
    I, J = np.nonzero(G53)
    Ab = jsp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), 53, 53,
                                type=gb.BOOL)
    want = G53.astype(np.float64) @ X53
    for Dc in (jpar.dist_csr_from_matrix(Ab, mesh, transpose=True),
               jpar.dist_csr_from_matrix(
                   Ab, mesh, boundaries=[0, 3, 9, 20, 21, 30, 40, 50, 53])):
        Pc = convert.from_jax(Dc, mesh=world1)
        assert (Pc.nrows, Pc.ncols, Pc.type.name) == (53, 53, "BOOL")
        np.testing.assert_allclose(dist_csr_mxv(Pc, X53).numpy(), want,
                                   **TOL[np.dtype(np.float32)])
