"""PyTorch port, the value-panel engine (``sparse/valdot.py``) and its
gather-dot kernel's plain version: parity with the JAX package.

The same valued CSR operands (numpy values made from a seed, converted
with ``convert.from_jax``) and the same semiring (``convert.from_jax``)
go through ``graphblas_tpu.sparse.valdot`` and the port.  Plans must
agree exactly (levels, live lists, pair counts); output patterns and
integer values exactly; float values within rtol=2e-5, atol=2e-6 (the
reassociation tolerance of ``tests/test_valdot.py``).  Mirrors
``test_valdot``."""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core.semirings import semiring as jsemiring
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.sparse import esc as jesc
from graphblas_tpu.sparse import valdot as jvd
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import _build, convert
from graphblas_tpu_torch.sparse import bitdot as tbd
from graphblas_tpu_torch.sparse import container as tcontainer
from graphblas_tpu_torch.sparse import esc as tesc
from graphblas_tpu_torch.sparse import valdot as tvd

from tests.test_torch_esc import assert_same_csr, tuples_of


def _powerlaw(rng, n=600, alpha=1.2, mult=3):
    deg = np.minimum((rng.pareto(alpha, n) * mult).astype(int) + 1, n - 1)
    I = np.repeat(np.arange(n), deg)
    J = rng.integers(0, n, size=len(I))
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    return lin // n, lin % n, n


def _vals(rng, k, dtype):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(1, 9, k).astype(dtype)
    return (rng.random(k) * 4 - 2).astype(dtype)


def _valued(I, J, n, tname, vals):
    Aj = jsp.CsrMatrix.from_coo(I, J, vals, n, n, type=getattr(gb, tname),
                                sum_duplicates=False)
    return Aj, convert.from_jax(Aj, device="cpu")


@pytest.fixture
def graph():
    r = np.random.default_rng(77)
    I, J, n = _powerlaw(r, n=500)
    return r, I, J, n, I > J


def _lum(graph, dtype, tname, mvals=None):
    """L, U, M of the graph in both packages: (jax triple, port triple)."""
    r, I, J, n, lo = graph
    k = int(lo.sum())
    L = _valued(I[lo], J[lo], n, tname, _vals(r, k, dtype))
    U = _valued(J[lo], I[lo], n, tname, _vals(r, k, dtype))
    M = _valued(I[lo], J[lo], n, tname,
                _vals(r, k, dtype) if mvals is None else mvals)
    return tuple(x[0] for x in (L, U, M)), tuple(x[1] for x in (L, U, M))


@pytest.fixture
def min_lanes_1(monkeypatch):
    """Let the plans take the heavy columns at test size (both
    packages)."""
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)


CASES = [("plus_times", np.float32, "FP32"),
         ("plus_times", np.int32, "INT32"),
         ("min_plus", np.float32, "FP32"),
         ("max_times", np.float64, "FP64"),
         ("plus_pair", np.float32, "FP32")]


@pytest.mark.parametrize("srname,dtype,tname", CASES)
def test_plan_matches_jax(graph, srname, dtype, tname):
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, dtype, tname)
    srj = jsemiring[srname][getattr(gb, tname)]
    srt = convert.from_jax(srj)
    pj = jvd.build_valdot_plan(Mj, Lj, Uj, srj, min_lanes=1)
    pt = tvd.build_valdot_plan(Mt, Lt, Ut, srt, min_lanes=1)
    assert pj is not None and pt is not None
    assert (pt.S, pt.kcut, pt.covered_lanes, pt.light_lanes,
            pt.finite_ok) == (pj.S, pj.kcut, pj.covered_lanes,
                              pj.light_lanes, pj.finite_ok)
    assert np.array_equal(pt.cnt.numpy(), np.asarray(pj.cnt))
    assert len(pt.levels) == len(pj.levels)
    for lt, lj in zip(pt.levels, pj.levels):
        assert (lt.S, lt.na, lt.nb, lt.nlive, lt.covered) == \
            (lj.S, lj.na, lj.nb, lj.nlive, lj.covered)
        for f in ("live_idx", "live_ai", "live_bj", "a_rows", "a_slots",
                  "b_js", "b_slots"):
            assert np.array_equal(getattr(lt, f).numpy(),
                                  np.asarray(getattr(lj, f))), f
        Av, Bv, _, _ = tvd._pack_level(lt)
        Avj, Bvj, _, _ = jvd._pack_level(lj)
        assert np.array_equal(Av.numpy(), np.asarray(Avj).reshape(
            Av.shape))
    assert pt.A_light.nvals == pj.A_light.nvals


@pytest.mark.parametrize("srname,dtype,tname", CASES)
def test_valdot_matches_jax(graph, min_lanes_1, srname, dtype, tname):
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, dtype, tname)
    srj = jsemiring[srname][getattr(gb, tname)]
    srt = convert.from_jax(srj)
    Cj = jvd.valdot_masked_spgemm(srj, Lj, Uj, Mj)
    Ct = tvd.valdot_masked_spgemm(srt, Lt, Ut, Mt)
    assert Cj is not None and Ct is not None
    assert gt.jax_engine_name(gt.last_axb_method()) == jax_last_method()
    assert_same_csr(Ct, Cj)
    # and the ESC engine (itself held against the JAX package) agrees
    assert_same_csr(Ct, jesc.csr_spgemm(srj, Lj, Uj, mask=Mj))


def test_valdot_hybrid_matches_jax(graph, min_lanes_1):
    """Narrow slabs, so the marginal rule leaves a residual for ESC and
    the hybrid merge runs."""
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, np.float32, "FP32")
    srj = jsemiring.plus_times[gb.FP32]
    srt = gt.semiring.plus_times[gt.FP32]
    pj = jvd.build_valdot_plan(Mj, Lj, Uj, srj, min_lanes=1, level_cols=32,
                               max_levels=3)
    pt = tvd.build_valdot_plan(Mt, Lt, Ut, srt, min_lanes=1, level_cols=32,
                               max_levels=3)
    assert pt.light_lanes == pj.light_lanes > 0
    Mj._options[("valdot_plan", "FP32", "FP32")] = (
        jvd._ref(Lj.indices), jvd._ref(Lj.values), jvd._ref(Uj.indices),
        jvd._ref(Uj.values), pj)
    Mt._options[("valdot_plan", "FP32", "FP32")] = (
        *(lambda x=x: x for x in (Lt.indices, Lt.values, Ut.indices,
                                  Ut.values)), pt)
    Cj = jvd.valdot_masked_spgemm(srj, Lj, Uj, Mj)
    Ct = tvd.valdot_masked_spgemm(srt, Lt, Ut, Mt)
    assert gt.last_axb_method() == jax_last_method() == "valdot:hybrid"
    assert_same_csr(Ct, Cj)


def test_valdot_valued_mask_truthiness(graph, min_lanes_1):
    """Falsy mask values must not produce output entries."""
    r = graph[0]
    k = int(graph[4].sum())
    mv = r.random(k).astype(np.float32)
    mv[mv < 0.5] = 0.0                      # half the mask is falsy
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, np.float32, "FP32", mv)
    srj = jsemiring.plus_times[gb.FP32]
    Cj = jvd.valdot_masked_spgemm(srj, Lj, Uj, Mj)
    Ct = tvd.valdot_masked_spgemm(convert.from_jax(srj), Lt, Ut, Mt)
    assert_same_csr(Ct, Cj)
    assert Ct.nvals < int((Mt.values[:Mt.nvals] != 0).sum()) + 1
    Cs = tvd.valdot_masked_spgemm(convert.from_jax(srj), Lt, Ut, Mt,
                                  structural=True)
    assert_same_csr(Cs, jvd.valdot_masked_spgemm(srj, Lj, Uj, Mj,
                                                 structural=True))
    assert Cs.nvals > Ct.nvals


def test_valdot_refuses_small_and_udt(graph):
    I = np.array([1, 2, 2, 3, 3, 3])
    J = np.array([0, 0, 1, 0, 1, 2])
    A = gt.csr_from_coo(I, J, np.ones(6, np.float32), 4, 4,
                        sum_duplicates=False, device="cpu")
    sr = gt.semiring.plus_times[gt.FP32]
    # tiny wedge count: the plan refuses, the caller falls back
    assert tvd.valdot_masked_spgemm(sr, A, A, A) is None
    assert tvd.cached_plan(A, A, A, sr) is None
    Aj = jsp.CsrMatrix.from_coo(I, J, np.ones(6, np.float32), 4, 4,
                                type=gb.FP32, sum_duplicates=False)
    assert jvd.valdot_masked_spgemm(jsemiring.plus_times[gb.FP32],
                                    Aj, Aj, Aj) is None

    # a user-defined type: the plan refuses, ESC raises a clear error
    # a user-defined semiring: the plan refuses it and ESC folds the
    # struct (here one FP32 field) to the plus_times values
    ut = gt.Type.udt("MYTYPE", v=gt.FP32)
    add = gt.BinaryOp("UPLUS", lambda x, y: {"v": x["v"] + y["v"]},
                      ut, ut, ut)
    mult = gt.BinaryOp("UTIMES", lambda a, b: {"v": a["v"] * b["v"]},
                       ut, ut, ut)
    sr_udt = gt.semiring_new(gt.monoid_new(add, {"v": 0.0}), mult)
    _, (Lt, Ut, Mt) = _lum(graph, np.float32, "FP32")

    def as_udt(X):
        return tcontainer.CsrMatrix(X.indptr, X.indices, X.rowids,
                                    {"v": X.values}, X.nvals, X.nrows,
                                    X.ncols, ut)
    Lu, Uu, Mu = as_udt(Lt), as_udt(Ut), as_udt(Mt)
    assert tvd.build_valdot_plan(Mu, Lu, Uu, sr_udt, min_lanes=1) is None
    got = tesc.csr_spgemm(sr_udt, Lu, Uu, mask=Mu, structural=True)
    want = tesc.csr_spgemm(sr, Lt, Ut, mask=Mt, structural=True)
    assert got.nvals == want.nvals
    assert torch.equal(got.indices[:got.nvals], want.indices[:want.nvals])
    assert torch.allclose(got.values["v"][:got.nvals],
                          want.values[:want.nvals], rtol=5e-5, atol=1e-4)
    with pytest.raises(TypeError, match="mask"):
        tesc.csr_spgemm(sr_udt, Lu, Uu, mask=Mu)


def test_valdot_plan_cache(graph, min_lanes_1, monkeypatch):
    _, (Lt, Ut, Mt) = _lum(graph, np.float32, "FP32")
    sr = gt.semiring.plus_times[gt.FP32]
    c1 = tvd.valdot_masked_spgemm(sr, Lt, Ut, Mt)
    key = ("valdot_plan", "FP32", "FP32")
    entry = Mt._options.get(key)
    c2 = tvd.valdot_masked_spgemm(sr, Lt, Ut, Mt)
    assert Mt._options.get(key) is entry       # no rebuild
    assert tvd.cached_plan(Mt, Lt, Ut, sr) is entry[-1]
    assert torch.equal(c1.values[:c1.nvals], c2.values[:c2.nvals])
    # new values (same pattern) rebuild the plan
    U2 = gt.CsrMatrix(Ut.indptr, Ut.indices, Ut.rowids, Ut.values * 2,
                      Ut.nvals, Ut.nrows, Ut.ncols, Ut.type)
    assert tvd.cached_plan(Mt, Lt, U2, sr) is None
    c3 = tvd.valdot_masked_spgemm(sr, Lt, U2, Mt)
    assert Mt._options.get(key) is not entry
    assert tvd.cached_plan(Mt, Lt, Ut, sr) is None       # stale operands
    assert tvd.cached_plan(Mt, Lt, U2, sr) is Mt._options[key][-1]
    np.testing.assert_allclose(c3.values[:c3.nvals].numpy(),
                               2 * c1.values[:c1.nvals].numpy(), rtol=1e-6)
    # the plus_times path caches the value panels only
    plan = Mt._options[key][-1]
    assert all(lv.packed[2] is None and lv.packed[3] is None
               for lv in plan.levels if lv.packed is not None)
    assert all(lv.rows is None for lv in plan.levels)
    # the kernel route (its gate forced open; on the CPU the wrapper runs
    # its plain version): every slab's compacted rows are cached and no
    # panel, whatever the budget, and the plan's bytes count the rows
    monkeypatch.setattr(tvd, "_use_kernel", lambda *a: True)
    for budget in (None, 1):
        Mk = gt.CsrMatrix(Mt.indptr, Mt.indices, Mt.rowids, Mt.values,
                          Mt.nvals, Mt.nrows, Mt.ncols, Mt.type)
        ck = tvd.valdot_masked_spgemm(sr, Lt, Ut, Mk, budget_bytes=budget)
        pk = tvd.cached_plan(Mk, Lt, Ut, sr)
        assert len(pk.levels) == len(plan.levels)
        assert all(lv.rows is not None and lv.packed is None
                   for lv in pk.levels)
        rows_bytes = sum(x.numel() * x.element_size() for lv in pk.levels
                         for R in lv.rows for x in R)
        assert pk.panel_bytes == rows_bytes > 0
        assert tvd.valdot_masked_spgemm(sr, Lt, Ut, Mk) is not None
        assert tvd.cached_plan(Mk, Lt, Ut, sr) is pk          # no rebuild
        assert_same_csr(ck, c1)


def test_fast_path_and_nonfinite_guard(graph, min_lanes_1):
    """Finite values: the plus_times path equals the bitmap path; an
    inf value makes the plan take the bitmap path (zero pads would
    poison inf*0), as the JAX package's does."""
    r, I, J, n, lo = graph
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, np.float32, "FP32")
    srj = jsemiring.plus_times[gb.FP32]
    srt = gt.semiring.plus_times[gt.FP32]
    key = ("valdot_plan", "FP32", "FP32")
    got = tvd.valdot_masked_spgemm(srt, Lt, Ut, Mt)
    assert Mt._options[key][-1].finite_ok
    assert_same_csr(got, tesc.csr_spgemm(srt, Lt, Ut, mask=Mt))
    vals = Uj.values[:Uj.nvals]
    vals = np.asarray(vals).copy()
    vals[0] = np.inf
    hp = Uj._options["host_pattern"]
    U2j, U2t = _valued(hp[0][:Uj.nvals], hp[1][:Uj.nvals], n, "FP32", vals)
    M2j, M2t = _valued(I[lo], J[lo], n, "FP32",
                       _vals(r, int(lo.sum()), np.float32))
    got2 = tvd.valdot_masked_spgemm(srt, Lt, U2t, M2t)
    want2 = jvd.valdot_masked_spgemm(srj, Lj, U2j, M2j)
    assert not M2t._options[key][-1].finite_ok
    assert not M2j._options[key][-1].finite_ok
    gi, gj, gx = tuples_of(got2)
    wi, wj, wx = tuples_of(want2)
    assert np.array_equal(gi, wi) and np.array_equal(gj, wj)
    assert np.array_equal(np.isfinite(gx), np.isfinite(wx))
    fin = np.isfinite(wx)
    np.testing.assert_allclose(gx[fin], wx[fin], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gatherdot_plain_matches_pallas_interpret(dtype):
    """The gather-dot kernel's plain version against the JAX package's
    fused Pallas gather-dot in interpret mode (the shapes of
    ``test_valdot.py:245-269``): padded lists, nlive < E, a -1 index
    clipped; int32 exact, float32 within rtol=1e-5."""
    r = np.random.default_rng(5)
    na, nb, S = 96, 80, 1024
    Av = r.integers(0, 7, (na, 8, S // 8)).astype(dtype)
    Bv = r.integers(0, 7, (nb, 8, S // 8)).astype(dtype)
    E, nlive = 384, 301
    ai = r.integers(-1, na, E).astype(np.int32)
    bj = r.integers(0, nb, E).astype(np.int32)
    want = np.asarray(jvd._pallas_gatherdot(
        jnp.asarray(Av), jnp.asarray(Bv), jnp.asarray(ai), jnp.asarray(bj),
        nlive, interpret=True))
    before = dict(_build.launches)
    got = tvd.valdot_gatherdot(
        torch.from_numpy(Av.reshape(na, S)),
        torch.from_numpy(Bv.reshape(nb, S)), torch.from_numpy(ai),
        torch.from_numpy(bj), nlive).numpy()
    assert _build.launches == before         # CPU: the plain version
    assert got.dtype == want.dtype
    if dtype == np.int32:
        assert np.array_equal(got[:nlive], want[:nlive])
    else:
        np.testing.assert_allclose(got[:nlive], want[:nlive], rtol=1e-5)
    assert not got[nlive:].any()


def test_gatherdot_int32_wraps():
    Av = torch.full((2, 8), 1 << 20, dtype=torch.int32)
    Bv = torch.full((3, 8), 1 << 20, dtype=torch.int32)
    ai = torch.tensor([0, 1, 5], dtype=torch.int32)
    bj = torch.tensor([2, -1, 0], dtype=torch.int32)
    got = tvd.valdot_gatherdot(Av, Bv, ai, bj, 3)
    want = np.int64(8 << 40) % (1 << 32)    # 8 * 2^40 wraps to 0
    assert got.tolist() == [int(want)] * 3


def test_gatherdot_wrapper_checks():
    A = torch.zeros(4, 8)
    B = torch.zeros(5, 8)
    i = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        tvd.valdot_gatherdot(torch.zeros(4, 6), torch.zeros(5, 6), i, i, 3)
    with pytest.raises(TypeError, match="float32 or int32"):
        tvd.valdot_gatherdot(A.double(), B.double(), i, i, 3)
    with pytest.raises(TypeError, match="differ"):
        tvd.valdot_gatherdot(A, B.to(torch.int32), i, i, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tvd.valdot_gatherdot(torch.zeros(8, 4).t(), B, i, i, 3)
    with pytest.raises(TypeError, match="int32"):
        tvd.valdot_gatherdot(A, B, i.long(), i, 3)


def _narrow_plan(Lt, Ut, Mt, sr, monkeypatch):
    """A plan of 6-column slabs: a width the gather-dot kernel refuses
    (the fixed slab cost is zeroed so such narrow slabs pay)."""
    monkeypatch.setattr(tvd, "_LEVEL_OVERHEAD_S", 0.0)
    plan = tvd.build_valdot_plan(Mt, Lt, Ut, sr, min_lanes=1, level_cols=6)
    assert plan is not None and plan.S == 6 and plan.finite_ok
    assert any(lv.nlive for lv in plan.levels)
    return plan


def test_kernel_gate_has_no_fallback(graph, monkeypatch):
    """The kernel gate is the JAX package's with "a CUDA tensor" for its
    backend test, whatever the slab width; on the kernel route a width
    the kernel cannot take raises instead of running the plain pass."""
    sr = gt.semiring.plus_times[gt.FP32]
    cuda = torch.device("cuda")
    assert tvd._use_kernel(sr, True, cuda)
    assert tvd._use_kernel(gt.semiring.plus_times[gt.INT32], True, cuda)
    assert not tvd._use_kernel(sr, True, torch.device("cpu"))
    assert not tvd._use_kernel(sr, False, cuda)
    assert not tvd._use_kernel(gt.semiring.plus_times[gt.FP64], True, cuda)
    _, (Lt, Ut, Mt) = _lum(graph, np.float32, "FP32")
    plan = _narrow_plan(Lt, Ut, Mt, sr, monkeypatch)
    acc, _ = tvd._valdot_heavy(plan, sr, Mt)     # CPU: the plain pass
    assert acc.shape == (Mt.nzmax,)
    monkeypatch.setattr(tvd, "_use_kernel", lambda *a: True)
    with pytest.raises(ValueError, match="multiple of 4"):
        tvd._valdot_heavy(plan, sr, Mt)


@pytest.mark.cuda
def test_narrow_slab_raises_on_card(graph, monkeypatch):
    """On the card a plus_times FP32 plan of 6-column slabs raises in the
    gather-dot wrapper; it never runs the plain pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # _lum's L, U, M (the same value draws), built on the card directly
    r, I, J, n, lo = graph
    k = int(lo.sum())
    Lt, Ut, Mt = (gt.csr_from_coo(a, b, _vals(r, k, np.float32), n, n,
                                  type=gt.FP32, sum_duplicates=False,
                                  device="cuda")
                  for a, b in ((I[lo], J[lo]), (J[lo], I[lo]),
                               (I[lo], J[lo])))
    sr = gt.semiring.plus_times[gt.FP32]
    plan = _narrow_plan(Lt, Ut, Mt, sr, monkeypatch)
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="multiple of 4"):
        tvd._valdot_heavy(plan, sr, Mt)
    assert _build.launches == before


@pytest.mark.cuda
def test_gatherdot_kernel_on_card():
    """The kernel against its plain version on the card (int32 exact,
    float32 within the reassociation bound S * 2^-24 * sum|a*b|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.int32):
        S, na, nb, E, nlive = 1024, 300, 250, 5000, 4801
        if dt == torch.float32:
            Av = torch.rand(na, S, generator=g) - 0.5
            Bv = torch.rand(nb, S, generator=g) - 0.5
        else:
            Av = torch.randint(-1000, 1000, (na, S), generator=g,
                               dtype=torch.int32)
            Bv = torch.randint(-1000, 1000, (nb, S), generator=g,
                               dtype=torch.int32)
        ai = torch.randint(-1, na, (E,), generator=g, dtype=torch.int32)
        bj = torch.randint(0, nb, (E,), generator=g, dtype=torch.int32)
        args = [x.cuda() for x in (Av, Bv, ai, bj)]
        got = tvd.valdot_gatherdot(*args, nlive)
        torch.cuda.synchronize()
        want = tvd._gatherdot_plain(*args, nlive)
        if dt == torch.int32:
            assert torch.equal(got, want)
        else:
            a = args[0][args[2][:nlive].long().clamp(0, na - 1)].double()
            b = args[1][args[3][:nlive].long()].double()
            bound = S * 2.0 ** -24 * (a * b).abs().sum(1)
            assert bool(((got[:nlive].double() - (a * b).sum(1)).abs()
                         <= bound).all())
            assert not got[nlive:].any()


def test_engine_names_and_convert(graph, min_lanes_1):
    """Engine names map to the JAX package's through jax_engine_name;
    convert.from_jax gives the same valued containers and semiring."""
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, np.int32, "INT32")
    assert Lt.type is gt.INT32 and Lt.values.dtype == torch.int32
    assert np.array_equal(Lt.values.numpy(), np.asarray(Lj.values))
    srj = jsemiring.plus_times[gb.INT32]
    srt = convert.from_jax(srj)
    assert srt is gt.semiring.plus_times[gt.INT32] or \
        srt == gt.semiring.plus_times[gt.INT32]
    assert convert.semiring_by_name("PLUS", "TIMES", "INT32") == srt
    for tname, dtype in (("FP64", np.float64), ("BOOL", np.bool_)):
        Xj = jsp.CsrMatrix.from_coo([0, 1], [1, 0],
                                    np.array([1, 0], dtype), 2, 2,
                                    type=getattr(gb, tname))
        Xt = convert.from_jax(Xj, device="cpu")
        assert Xt.type.name == tname
        assert np.array_equal(Xt.values.numpy(), np.asarray(Xj.values))
    tvd.valdot_masked_spgemm(srt, Lt, Ut, Mt)
    jvd.valdot_masked_spgemm(srj, Lj, Uj, Mj)
    assert gt.last_axb_method() == jax_last_method() == "valdot:full"
    assert gt.jax_engine_name("valdot:hybrid") == "valdot:hybrid"
