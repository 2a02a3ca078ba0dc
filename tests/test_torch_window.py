"""PyTorch port, band/window plans and the band-ring / window-count
kernels' plain versions: parity with the JAX package.

The same banded graphs, made with numpy from a seed, build plans in both
packages; the panels must be equal, and the port's per-block partials
(the kernels' plain PyTorch versions on the CPU) must equal the JAX
package's Pallas kernels run in interpret mode.  Exact equality: every
quantity is an integer.  The kernels' schedules of nonempty tiles
(``band_schedule``, ``window_schedule``) are held against a numpy
enumeration of the tile triples, and the plain versions over them
against the dense plain versions and the JAX kernels; the card-only
tests (``cuda`` marker) hold the kernels against their plain versions
on random signed int8 panels."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.sparse import pallas_window as jpw
from graphblas_tpu.sparse import window as jw
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.ops.flopcount import jax_engine_name
from graphblas_tpu_torch.sparse import cuda_window as cw
from graphblas_tpu_torch.sparse import window as tw


def _banded_lu(n, bw, density, seed):
    rng = np.random.default_rng(seed)
    sym = rng.random((n, n)) < density
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    out = {}
    for name, pat in (("L", np.tril(Ap)), ("U", np.triu(Ap))):
        I, J = np.nonzero(pat)
        X = np.ones(len(I), bool)
        out[name] = (gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL,
                                     device="cpu"),
                     jsp.csr_from_coo(I, J, X, n, n, type=gb.BOOL))
    return out["L"], out["U"], Ap


# (n, band width, density, seed): the JAX window test's graph, and a
# wider band whose plan has Wb >= 4 blocks
GRAPHS = [(700, 90, 0.15, 0), (1200, 420, 0.03, 1)]


@pytest.fixture(scope="module", params=GRAPHS, ids=["bw90", "wb4"])
def graph(request):
    n, bw, density, seed = request.param
    (Lt, Lj), (Ut, Uj), Ap = _banded_lu(n, bw, density, seed)
    Af = Ap.astype(np.float64)
    want = int(round(((Af @ Af) * Af).sum())) // 6
    return Lt, Lj, Ut, Uj, want


def test_band_plan_matches_jax(graph):
    Lt, Lj, Ut, Uj, _ = graph
    pt, pj = gt.build_band_plan(Lt, Ut), jw.build_band_plan(Lj, Uj)
    assert pt is not None and pj is not None
    assert (pt.nI, pt.Wb, pt.ntriples, pt.nedges) == \
        (pj.nI, pj.Wb, pj.ntriples, pj.nedges)
    assert np.array_equal(pt.P.numpy(), np.asarray(pj.P))
    assert np.array_equal(pt.Ut.numpy(), np.asarray(pj.Ut))
    assert pt.panel_bytes == pj.panel_bytes


def test_window_plan_matches_jax(graph):
    Lt, Lj, Ut, Uj, _ = graph
    pt, pj = gt.build_window_plan(Lt, Ut, Lt), jw.build_window_plan(Lj, Uj, Lj)
    assert pt is not None and pj is not None
    assert (pt.nI, pt.Wmax, pt.nJmax, pt.ntriples) == \
        (pj.nI, pj.Wmax, pj.nJmax, pj.ntriples)
    for a, b in ((pt.P, pj.P), (pt.Q, pj.Q), (pt.M, pj.M)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(pt.k0, pj.k0) and np.array_equal(pt.j0, pj.j0)


def test_band_partials_match_jax_kernel(graph):
    Lt, Lj, Ut, Uj, want = graph
    got = gt.tricount_band_partials(gt.build_band_plan(Lt, Ut))
    assert gt.last_axb_method() == "torch:tri_band_ring"
    ref = np.asarray(jpw.tricount_band_partials(jw.build_band_plan(Lj, Uj)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert int(got.sum(dtype=torch.int64)) == want
    assert jax_engine_name(gt.last_axb_method()) == "pallas:tri_band_ring"


def test_window_partials_match_jax_kernel(graph):
    Lt, Lj, Ut, Uj, want = graph
    got = gt.window_count_partials(gt.build_window_plan(Lt, Ut, Lt))
    assert gt.last_axb_method() == "torch:window_count"
    ref = np.asarray(jpw.window_count_partials(
        jw.build_window_plan(Lj, Uj, Lj)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert int(got.sum(dtype=torch.int64)) == want
    assert jax_engine_name(gt.last_axb_method()) == "pallas:window_count"


def test_window_count_sum_and_tricount_window(graph):
    Lt, Lj, Ut, Uj, want = graph
    assert gt.tricount_window(Lt, Ut) == jw.tricount_window(Lj, Uj) == want
    assert gt.last_axb_method() == "window:count_sum"


def test_convert_roundtrips_jax_plans(graph):
    Lt, Lj, Ut, Uj, want = graph
    bj = jw.build_band_plan(Lj, Uj)
    bt = convert.from_jax(bj, device="cpu")
    assert (bt.nI, bt.Wb, bt.ntriples) == (bj.nI, bj.Wb, bj.ntriples)
    assert np.array_equal(bt.Ut.numpy(), np.asarray(bj.Ut))
    assert int(gt.tricount_band_partials(bt).sum()) == want
    wj = jw.build_window_plan(Lj, Uj, Lj)
    wt = convert.from_jax(wj, device="cpu")
    assert (wt.Wmax, wt.nJmax, wt.shape) == (wj.Wmax, wj.nJmax, wj.shape)
    assert int(gt.window_count_partials(wt).sum()) == want


def test_plans_refuse_unstructured():
    n = 128 * (gt.sparse.window.MAX_W_BLOCKS + 2)
    rng = np.random.default_rng(4)
    I, J = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    lo = I > J
    L = gt.csr_from_coo(I[lo], J[lo], np.ones(lo.sum(), bool), n, n,
                        device="cpu")
    U = L.T()
    assert gt.build_band_plan(L, U) is None
    assert gt.build_window_plan(L, U, L) is None
    assert gt.tricount_window(L, U) is None


@pytest.mark.parametrize("which", ["band", "window"])
def test_wrappers_reject_bad_panels(which):
    (Lt, _), (Ut, _), _ = _banded_lu(300, 40, 0.2, 5)
    if which == "band":
        plan = gt.build_band_plan(Lt, Ut)
        plan.P = plan.P.to(torch.int32)
        fn = gt.tricount_band_partials
    else:
        plan = gt.build_window_plan(Lt, Ut, Lt)
        plan.Q = plan.Q[:, :-128]
        fn = gt.window_count_partials
    with pytest.raises((TypeError, ValueError)):
        fn(plan)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    # without the CUDA toolkit the kernel build raises; nothing falls
    # back to the plain version for a CUDA tensor
    from graphblas_tpu_torch import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


# ---------------------------------------------------------------------------
# The count kernels' schedules of nonempty tiles
# ---------------------------------------------------------------------------

def _tiles_nonzero(x):
    """(n, R/128, C/128) numpy bool: the 128x128 tiles holding a
    nonzero."""
    n, R, C = x.shape
    return (np.asarray(x.cpu()).reshape(n, R // 128, 128, C // 128, 128)
            != 0).any((2, 4))


def _band_triples(P, Ut):
    """Every (i, s, kb) whose mask, A and B tiles are nonempty, by loops."""
    occP, occU = _tiles_nonzero(P)[:, 0], _tiles_nonzero(Ut)[:, :, 0]
    nI, Wb = occP.shape
    return {(i, s, kb) for i in range(nI) for s in range(min(Wb, i + 1))
            for kb in range(s + 1)
            if occP[i, Wb - 1 - s] and occP[i, Wb - 1 - s + kb]
            and occU[i - s, kb]}


def _window_triples(P, Q, M):
    occP, occQ, occM = (_tiles_nonzero(P)[:, 0], _tiles_nonzero(Q),
                        _tiles_nonzero(M)[:, 0])
    nI, nK = occP.shape
    return {(i, c, kb) for i in range(nI) for c in range(occM.shape[1])
            for kb in range(nK) if occM[i, c] and occP[i, kb]
            and occQ[i, kb, c]}


def _schedule_triples(sched):
    """The schedule's (row, col, k-block) triples, after checking its
    form: int32, heaviest output first, ascending k-blocks, no empty
    output and no output twice."""
    for x in (sched.rows, sched.cols, sched.kptr, sched.kblk):
        assert x.dtype == torch.int32
    kptr = sched.kptr.tolist()
    counts = np.diff(kptr)
    assert kptr[0] == 0 and (counts >= 1).all()
    assert (counts[:-1] >= counts[1:]).all()
    outs = list(zip(sched.rows.tolist(), sched.cols.tolist()))
    assert len(set(outs)) == len(outs) == sched.nout
    kb = sched.kblk.tolist()
    got = set()
    for o, (r, c) in enumerate(outs):
        ks = kb[kptr[o]:kptr[o + 1]]
        assert ks == sorted(set(ks))
        got.update((r, c, k) for k in ks)
    assert len(got) == sched.ntriples
    return got


@pytest.mark.parametrize("kind", ["band", "window"])
def test_scheduled_plain_matches_dense_and_jax(graph, kind):
    # the plain version over the schedule's tile triples equals the dense
    # plain version and the JAX kernel (interpret mode), and the schedule
    # holds exactly the plan's tile triples
    Lt, Lj, Ut, Uj, want = graph
    if kind == "band":
        plan = gt.build_band_plan(Lt, Ut)
        sched = tw.band_schedule(plan)
        got = cw._tri_band_partials_scheduled(plan.P, plan.Ut, sched)
        dense = cw._tri_band_partials_plain(plan.P, plan.Ut)
        ref = jpw.tricount_band_partials(jw.build_band_plan(Lj, Uj),
                                         interpret=True)
        brute = _band_triples(plan.P, plan.Ut)
    else:
        plan = gt.build_window_plan(Lt, Ut, Lt)
        sched = tw.window_schedule(plan)
        got = cw._window_count_scheduled(plan.P, plan.Q, plan.M, sched)
        dense = cw._window_count_plain(plan.P, plan.Q, plan.M)
        ref = jpw.window_count_partials(jw.build_window_plan(Lj, Uj, Lj),
                                        interpret=True)
        brute = _window_triples(plan.P, plan.Q, plan.M)
    assert got.dtype == torch.int32
    assert torch.equal(got, dense)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum(dtype=torch.int64)) == want
    assert _schedule_triples(sched) == brute
    assert sched.ntriples == plan.ntriples


@pytest.mark.parametrize("kind", ["band", "window"])
def test_schedule_built_once(graph, kind):
    # the first call builds the schedule on the plan; later calls return
    # the same object and build nothing; new panels get a new schedule;
    # a plan converted from the JAX package takes the same path
    Lt, Lj, Ut, Uj, _ = graph
    if kind == "band":
        plan = gt.build_band_plan(Lt, Ut)
        plan.schedule = None
        make = tw.band_schedule
        conv = convert.from_jax(jw.build_band_plan(Lj, Uj), device="cpu")
    else:
        plan = gt.build_window_plan(Lt, Ut, Lt)
        plan.schedule = None
        make = tw.window_schedule
        conv = convert.from_jax(jw.build_window_plan(Lj, Uj, Lj),
                                device="cpu")
    before = tw.schedule_builds[kind]
    sched = make(plan)
    assert plan.schedule is sched
    assert make(plan) is sched
    assert tw.schedule_builds[kind] == before + 1
    # the CPU wrapper runs the dense plain version and builds nothing
    fn = (gt.tricount_band_partials if kind == "band"
          else gt.window_count_partials)
    fn(plan)
    assert plan.schedule is sched
    assert tw.schedule_builds[kind] == before + 1
    again = make(conv)
    for a, b in ((again.rows, sched.rows), (again.cols, sched.cols),
                 (again.kptr, sched.kptr), (again.kblk, sched.kblk)):
        assert torch.equal(a, b)
    plan.P = plan.P.clone()
    assert make(plan) is not sched
    assert tw.schedule_builds[kind] == before + 3


def _random_band(rng, nI, Wb, lo=-2, hi=3):
    P = torch.from_numpy(rng.integers(lo, hi, (nI, 128, Wb * 128))
                         .astype(np.int8))
    Ut = torch.from_numpy(rng.integers(lo, hi, (nI, Wb * 128, 128))
                          .astype(np.int8))
    return gt.BandPlan(P, Ut, nI, Wb, 0, 0)


def _random_window(rng, nI, Wk, nJb, lo=-2, hi=3):
    P = torch.from_numpy(rng.integers(lo, hi, (nI, 128, Wk * 128))
                         .astype(np.int8))
    Q = torch.from_numpy(rng.integers(lo, hi, (nI, Wk * 128, nJb * 128))
                         .astype(np.int8))
    M = torch.from_numpy(rng.integers(lo, hi, (nI, 128, nJb * 128))
                         .astype(np.int8))
    return gt.WindowPlan(P, Q, M, nI, Wk, nJb, np.zeros(nI, np.int64),
                         np.zeros(nI, np.int64), 0, (nI * 128, Wk * 128),
                         (nI * 128, nJb * 128))


def _zero_tile(x, b, r, c):
    x[b, r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = 0


@pytest.mark.parametrize("kind", ["band", "window"])
def test_schedule_skips_empty_tiles(kind):
    # an all-zero mask tile over a nonzero product, and empty k-blocks at
    # the band's (window's) edges: the schedule leaves those triples out,
    # and the plain version over it still equals the dense plain version
    rng = np.random.default_rng(11)
    if kind == "band":
        plan = _random_band(rng, 6, 4)
        P, Ut = plan.P, plan.Ut
        # mask tile L(4, 2): P[4]'s column block jj = 1 (s = 2)
        _zero_tile(P, 4, 0, 1)
        for i in range(6):
            _zero_tile(P, i, 0, 0)         # the band's left edge
            _zero_tile(Ut, i, 3, 0)        # U's last block of each row
        sched = tw.band_schedule(plan)
        got = cw._tri_band_partials_scheduled(P, Ut, sched)
        assert torch.equal(got, cw._tri_band_partials_plain(P, Ut))
        triples = _schedule_triples(sched)
        assert triples == _band_triples(P, Ut)
        assert not any(t[:2] == (4, 2) for t in triples)
        assert not any(t[1] == 3 for t in triples)  # jj = 0 is empty
        # the product under the zeroed mask tile is not zero
        assert bool((P[4, :, 128:512].double()
                     @ Ut[2, :384].double()).any())
    else:
        plan = _random_window(rng, 5, 3, 4)
        P, Q, M = plan.P, plan.Q, plan.M
        _zero_tile(M, 2, 0, 1)
        for i in range(5):
            _zero_tile(P, i, 0, 0)
            _zero_tile(Q, i, 2, 3)
        sched = tw.window_schedule(plan)
        got = cw._window_count_scheduled(P, Q, M, sched)
        assert torch.equal(got, cw._window_count_plain(P, Q, M))
        triples = _schedule_triples(sched)
        assert triples == _window_triples(P, Q, M)
        assert not any(t[:2] == (2, 1) for t in triples)
        assert not any(t[2] == 0 for t in triples)
        assert bool((P[2].double() @ Q[2][:, 128:256].double()).any())


@pytest.mark.parametrize("kind", ["band", "window"])
def test_schedule_of_empty_panels(kind):
    rng = np.random.default_rng(12)
    plan = (_random_band(rng, 3, 2, 0, 1) if kind == "band"
            else _random_window(rng, 3, 2, 2, 0, 1))
    sched = (tw.band_schedule(plan) if kind == "band"
             else tw.window_schedule(plan))
    assert sched.nout == sched.ntriples == 0
    assert sched.kptr.tolist() == [0]
    got = (cw._tri_band_partials_scheduled(plan.P, plan.Ut, sched)
           if kind == "band" else
           cw._window_count_scheduled(plan.P, plan.Q, plan.M, sched))
    assert got.tolist() == [0, 0, 0]


def _card_plan(kind, case, rng):
    """A random signed int8 plan on the card: every tile nonempty,
    scattered empty tiles, or every tile empty; values in -2..2, so every
    partial fits int32 (at most 4 * 128^2 * 2 * 512 * 4 < 2^31)."""
    plan = (_random_band(rng, 20, 4) if kind == "band"
            else _random_window(rng, 12, 4, 3))
    panels = ((plan.P, plan.Ut) if kind == "band"
              else (plan.P, plan.Q, plan.M))
    for x in panels:
        n, R, C = x.shape
        if case == "empty":
            x.zero_()
        elif case == "scattered":
            keep = rng.random((n, R // 128, 1, C // 128, 1)) < 0.6
            x.view(n, R // 128, 128, C // 128, 128).mul_(
                torch.from_numpy(keep.astype(np.int8)))
    if kind == "band":
        plan.P, plan.Ut = plan.P.cuda(), plan.Ut.cuda()
    else:
        plan.P, plan.Q, plan.M = plan.P.cuda(), plan.Q.cuda(), plan.M.cuda()
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "scattered", "empty"])
@pytest.mark.parametrize("kind", ["band", "window"])
def test_count_kernel_on_card(kind, case):
    """The band ring (K1) and the window count (K2) on the card against
    their dense plain versions and the plain versions over the schedule,
    exactly, on random signed int8 panels; one launch per call (none
    when every tile is empty), the schedule built once; a non-int8 panel
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphblas_tpu_torch import _build
    plan = _card_plan(kind, case, np.random.default_rng(13))
    name = "tri_band_ring" if kind == "band" else "window_count"
    if kind == "band":
        fn = gt.tricount_band_partials
        dense = cw._tri_band_partials_plain(plan.P, plan.Ut)
    else:
        fn = gt.window_count_partials
        dense = cw._window_count_plain(plan.P, plan.Q, plan.M)
    before = _build.launches[name]
    builds = tw.schedule_builds[kind]
    got = fn(plan)
    torch.cuda.synchronize()
    assert gt.last_axb_method() == f"cuda:{name}"
    sched = plan.schedule
    assert _build.launches[name] == before + (sched.nout > 0)
    assert got.dtype == torch.int32 and torch.equal(got, dense)
    if kind == "band":
        assert torch.equal(got, cw._tri_band_partials_scheduled(
            plan.P, plan.Ut, sched))
    else:
        assert torch.equal(got, cw._window_count_scheduled(
            plan.P, plan.Q, plan.M, sched))
    if case == "empty":
        assert sched.nout == 0 and not got.any()
    else:
        assert sched.nout > 0 and got.abs().sum() > 0
    assert torch.equal(fn(plan), got)
    assert tw.schedule_builds[kind] == builds + 1
    plan.P = plan.P.to(torch.int16)
    with pytest.raises(TypeError):
        fn(plan)


@pytest.mark.cuda
def test_count_kernels_on_card_banded_graph():
    """K1 and K2 on the card on a banded graph's plans (no JAX): equal to
    their plain versions and to the triangle count, the schedules'
    triples equal to the plans' tile-triple counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, bw = 1200, 420
    rng = np.random.default_rng(1)
    sym = rng.random((n, n)) < 0.03
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    Af = Ap.astype(np.float64)
    want = int(round(((Af @ Af) * Af).sum())) // 6
    L, U = (gt.csr_from_coo(*np.nonzero(p), np.ones(int(p.sum()), bool), n,
                            n, type=gt.BOOL, device="cuda")
            for p in (np.tril(Ap), np.triu(Ap)))
    bp = gt.build_band_plan(L, U)
    got = gt.tricount_band_partials(bp)
    assert torch.equal(got, cw._tri_band_partials_plain(bp.P, bp.Ut))
    assert int(got.sum(dtype=torch.int64)) == want
    assert bp.schedule.ntriples == bp.ntriples
    wp = gt.build_window_plan(L, U, L)
    got = gt.window_count_partials(wp)
    assert torch.equal(got, cw._window_count_plain(wp.P, wp.Q, wp.M))
    assert int(got.sum(dtype=torch.int64)) == want
    assert wp.schedule.ntriples == wp.ntriples
    assert gt.tricount_auto(L, U) == want
    assert gt.last_axb_method() == "cuda:tri_band_ring"
