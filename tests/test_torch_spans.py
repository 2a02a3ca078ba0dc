"""PyTorch port: the spans and named counts of ``utils/counters.py`` —
off unless a profiler records or ``trace_spans`` turns them on, nested
by thread with self times that add up, cleared by ``reset``, and the
device-to-host reads of the main paths counted exactly by
``host_read`` (on the CPU as on the card)."""

import json
import threading

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import bitdot as tbd
from graphblas_tpu_torch.sparse import valdot as tvd
from graphblas_tpu_torch.utils import counters, timer

DEV = "cpu"


@pytest.fixture
def spans_on():
    counters.reset()
    counters.trace_spans(True)
    yield
    counters.trace_spans(False)
    counters.reset()


def _wathen_lu(nx=16):
    """L and U of a small Wathen mesh with their host patterns (the band
    plan's input)."""
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    key = np.unique(I * n + J)
    I, J = key // n, key % n
    out = []
    for sel in (I > J, I < J):
        out.append(gt.csr_from_coo(I[sel], J[sel],
                                   np.ones(int(sel.sum()), bool), n, n,
                                   type=gt.BOOL, sum_duplicates=False,
                                   device=DEV))
    return out


def _rmat(scale):
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    I, J = gt.symmetrize_pattern(I, J, n)
    return gt.csr_from_coo(I, J, np.ones(len(I), bool), n, n, type=gt.BOOL,
                           sum_duplicates=False, device=DEV)


def _names(records):
    return [r.name for r in records]


def test_spans_off_record_nothing(monkeypatch):
    """Off, no annotation is ever opened and nothing is kept: a span is
    the shared null context, and a read still counts."""
    def boom(*a, **k):
        raise AssertionError("annotation opened with spans off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(counters, "_annotate", boom)
    counters.reset()
    assert counters.span("gb.a") is counters.span("gb.b")
    with counters.span("gb.entry.x"):
        pass
    L, U = _wathen_lu(8)
    assert gt.tricount_auto(L, U) == gt.tricount_auto(L, U)
    assert counters.span_records() == []
    st = counters.stats()
    assert st["spans"] == {}
    assert st["counts"]["reads"] == 2


def test_spans_nest_and_self_times_add_up(spans_on):
    with counters.span("gb.entry.a"):
        with counters.span("gb.engines.b"):
            with counters.span("gb.read.c"):
                pass
        with counters.span("gb.planning.d"):
            pass
    with counters.span("gb.entry.e"):
        pass
    recs = {r.name: r for r in counters.span_records()}
    a, b, c, d, e = (recs[k] for k in ("gb.entry.a", "gb.engines.b",
                                       "gb.read.c", "gb.planning.d",
                                       "gb.entry.e"))
    assert a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert {b.root, c.root, d.root} == {a.id}
    assert e.root == e.id != a.id
    for outer, inner in ((a, b), (b, c), (a, d)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    st = counters.stats()["spans"]
    total = (a.end_ns - a.start_ns) / 1e9
    own = sum(st[k]["self_s"] for k in ("gb.entry.a", "gb.engines.b",
                                        "gb.read.c", "gb.planning.d"))
    assert own == pytest.approx(total, rel=1e-9, abs=1e-12)
    assert st["gb.entry.a"]["total_s"] == pytest.approx(total)
    assert all(st[k]["count"] == 1 for k in st)


def test_spans_keep_threads_apart(spans_on):
    def work():
        with counters.span("gb.entry.t"):
            with counters.span("gb.engines.t"):
                pass
    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    recs = counters.span_records()
    roots = {r.id: r for r in recs if r.parent is None}
    assert len(roots) == 4
    for r in recs:
        if r.parent is not None:
            assert roots[r.root].thread == r.thread


def test_span_closes_on_exception(spans_on):
    with pytest.raises(ValueError):
        with counters.span("gb.entry.x"):
            raise ValueError("planted")
    with counters.span("gb.entry.y"):
        pass
    recs = counters.span_records()
    assert _names(recs) == ["gb.entry.x", "gb.entry.y"]
    assert recs[1].parent is None


def test_reset_clears_spans_and_counts(spans_on):
    with counters.span("gb.entry.x"):
        counters.count("reads")
    counters.bump("mxm")
    assert counters.stats()["counts"] == {"reads": 1}
    counters.reset()
    st = counters.stats()
    assert st["spans"] == {} and st["counts"] == {} and st["ops"] == {}
    assert counters.span_records() == []


def test_counts_follow_enable():
    counters.reset()
    counters.enable(False)
    try:
        counters.count("reads", 3)
        assert counters.stats()["counts"] == {}
    finally:
        counters.enable(True)
    counters.count("reads", 3)
    assert counters.stats()["counts"] == {"reads": 3}
    counters.reset()


def test_warm_band_count_reads_once(spans_on):
    """A warm ``tricount_auto`` on a Wathen band plan: one read (the
    count), one cached plan, three spans."""
    L, U = _wathen_lu(16)
    want = gt.tricount_auto(L, U)
    assert gt.last_axb_method() == "torch:tri_band_ring"
    st = counters.stats()
    assert st["counts"]["plan.band.built"] == 1
    assert st["spans"]["gb.planning.band_plan"]["count"] == 1
    counters.reset()
    for _ in range(3):
        assert gt.tricount_auto(L, U) == want
    st = counters.stats()
    assert st["counts"] == {"reads": 3, "plan.band.reused": 3}
    assert sorted(_names(counters.span_records())) == sorted(
        ["gb.entry.tricount_auto", "gb.engines.band_ring",
         "gb.read.tri_count"] * 3)


def _urand_split(n=4096, deg=6, seed=5):
    """``csr_tril``/``csr_triu`` of a uniform random symmetric pattern:
    its band is wider than ``MAX_W_BLOCKS`` blocks and it is too flat
    for the bitmaps, so the band, window and bitdot plans all refuse."""
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, n, n * deg // 2), rng.integers(0, n, n * deg // 2)
    keep = i != j
    key = np.unique(np.concatenate([i[keep] * n + j[keep],
                                    j[keep] * n + i[keep]]))
    A = gt.csr_from_coo(key // n, key % n, np.ones(len(key), bool), n, n,
                        type=gt.BOOL, sum_duplicates=False, device=DEV)
    return gt.csr_tril(A), gt.csr_triu(A)


def test_sort_merge_count_reads(spans_on):
    """The count of operands that every plan refuses, each refusal
    cached: the lane total and the count, two reads a warm call."""
    L, U = _urand_split()
    want = gt.tricount_auto(L, U)
    counters.reset()
    assert gt.tricount_auto(L, U) == want
    assert gt.last_axb_method() == "tri:sort_merge"
    assert counters.stats()["counts"] == {"reads": 2,
                                          "plan.band.reused": 1,
                                          "plan.window.reused": 1,
                                          "plan.bitdot.reused": 1}
    reads = [r.name for r in counters.span_records()
             if r.name.startswith("gb.read.")]
    assert sorted(reads) == ["gb.read.sort_merge_lanes", "gb.read.tri_count"]


def test_tril_triu_count_reads_once(spans_on):
    """The count of ``csr_tril``/``csr_triu`` of a Wathen mesh, as
    ``tri_demo`` counts: the band plan is built from the lanes copied
    back once (``gb.read.plan_pattern``, L and U), and a warm call is
    the band ring with one read."""
    I, J, X, n = gt.wathen_coo(8, 8, seed=1)
    A = gt.csr_from_coo(I, J, X, n, n, device=DEV)
    L, U = gt.csr_tril(A), gt.csr_triu(A)
    want = gt.tricount_auto(L, U)
    assert gt.last_axb_method() == "torch:tri_band_ring"
    assert counters.stats()["spans"]["gb.read.plan_pattern"]["count"] == 2
    counters.reset()
    assert gt.tricount_auto(L, U) == want
    assert counters.stats()["counts"] == {"reads": 1, "plan.band.reused": 1}
    assert sorted(_names(counters.span_records())) == sorted(
        ["gb.entry.tricount_auto", "gb.engines.band_ring",
         "gb.read.tri_count"])


def test_bfs_reads_levels_plus_one(spans_on):
    """``bfs_csr`` reads a frontier flag for each level with a frontier
    and once more for the empty one, then the levels: max level + 2."""
    A = _rmat(8)
    for s in (0, 3, 17):
        counters.reset()
        lev = gt.bfs_csr(A, s)
        levels = int(lev.max())
        st = counters.stats()
        assert st["counts"]["reads"] == levels + 2
        assert st["counts"]["d2h_bytes"] == lev.nbytes
        assert st["spans"]["gb.read.bfs_frontier"]["count"] == levels + 1
        assert st["spans"]["gb.engines.bfs_loop"]["count"] == 1
        assert st["spans"]["gb.entry.bfs_csr"]["count"] == 1


@pytest.mark.parametrize("scale", [8, 10])
def test_warm_bfs5m_sorts_and_copies_nothing_on_the_host(spans_on, scale):
    """A warm ``models.bfs5m`` on a CsrMatrix: its by-column twin is
    made on the device (no host sort, no copy, no host pattern read
    back), and it reads once a level: the successor flag and, in the
    same two-byte copy, whether the frontier is full, which the next
    level's ``vxm`` asks.  Only the first level's ``vxm`` reads that
    itself.  Nothing grows with nnz."""
    A = _rmat(scale)
    gt.models.bfs5m(A, 0)
    for s in (0, 3, 17):
        counters.reset()
        v = gt.models.bfs5m(A, s)
        levels = int(v.values.max())
        st = counters.stats()
        assert st["counts"] == {"transpose.entries": A.nvals,
                                "reads": levels + 1,
                                "d2h_bytes": 2 * levels}
        recs = counters.span_records()
        root = [r for r in recs if r.parent is None]
        assert _names(root) == ["gb.entry.bfs5m"]
        assert all(r.root == root[0].id for r in recs)
        names = set(_names(recs))
        assert names == {"gb.entry.bfs5m", "gb.containers.transpose",
                         "gb.engines.bitmap_assign", "gb.engines.spmv",
                         "gb.engines.bitmap_mask", "gb.read.all_present",
                         "gb.read.reduce_scalar"}
        assert st["spans"]["gb.containers.transpose"]["count"] == 1
        assert st["spans"]["gb.read.all_present"]["count"] == 1
        assert st["spans"]["gb.read.reduce_scalar"]["count"] == levels
        assert st["spans"]["gb.engines.spmv"]["count"] == levels
        np.testing.assert_array_equal(
            torch.where(v.pattern, v.values, 0).numpy(), gt.bfs_csr(A, s))


def test_bfs6_is_its_own_entry(spans_on):
    A = _rmat(8)
    counters.reset()
    gt.models.bfs6(A, 3)
    roots = [r.name for r in counters.span_records() if r.parent is None]
    assert roots == ["gb.entry.bfs6"]


def test_warm_masked_mxm_reads(spans_on):
    """A masked FP32 ``mxm`` into a fresh CSR C at R-MAT 13 (the valued
    plan refuses, ESC runs): every call reads the exact flop count and
    the epilogue's nnz; the cold call ESC's plan besides: its lane total
    (the sum of ``entry_lanes``, read from the card whether or not the
    operands keep a host pattern) and its nnz.  ESC's key sort takes the
    product's lanes alone, no mask key (``esc.sorted_lanes``)."""
    n = 1 << 13
    L, U = gt.tricount_prep_csr(_rmat(13))
    rng = np.random.default_rng(0)

    def valued(X):
        r, c = X.rowids[:X.nvals].numpy(), X.indices[:X.nvals].numpy()
        return gt.csr_from_coo(r, c, (rng.random(len(r)) + 0.5).astype(
            np.float32), n, n, type=gt.FP32, sum_duplicates=False,
            device=DEV)
    Lv, Uv, M = valued(L), valued(U), valued(L)
    e = np.zeros(0, np.int64)

    def call():
        C = gt.csr_from_coo(e, e, np.zeros(0, np.float32), n, n,
                            type=gt.FP32, device=DEV)
        counters.reset()
        gt.mxm(C, M, None, "plus_times", Lv, Uv)
        assert gt.last_axb_method() == "esc:csr_spgemm"
        return counters.stats()
    cold, warm, warm2 = call(), call(), call()
    hpL, hpU = Lv._options["host_pattern"], Uv._options["host_pattern"]
    lanes = int(np.bincount(hpU[0][:Uv.nvals], minlength=n)[
        hpL[1][:Lv.nvals]].sum())
    assert cold["counts"]["reads"] == 4
    assert cold["counts"]["plan.esc.built"] == 1
    assert cold["counts"]["flopcount.exact"] == 1
    assert warm["counts"] == warm2["counts"] == {
        "reads": 2, "plan.valdot.reused": 1, "plan.esc.reused": 1,
        "flopcount.exact": 1, "esc.sorted_lanes": lanes}
    names = set(warm["spans"])
    assert {"gb.entry.mxm", "gb.planning.flopcount", "gb.read.flopcount",
            "gb.planning.choose", "gb.engines.esc", "gb.engines.accum_mask",
            "gb.read.accum_nnz"} == names
    assert "gb.planning.esc_plan" in cold["spans"]
    assert "gb.planning.valdot_plan" in cold["spans"]


def test_warm_valdot_counts_slabs_and_lanes(spans_on, monkeypatch):
    """The value-panel engine on a cached hybrid plan: one read (its
    nnz), its slabs and live lanes counted, and the residual's lanes
    alone sorted."""
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    A = _rmat(9)
    n = A.nrows
    L, U = gt.tricount_prep_csr(A)
    rng = np.random.default_rng(1)

    def valued(X):
        r, c = X.rowids[:X.nvals].numpy(), X.indices[:X.nvals].numpy()
        return gt.csr_from_coo(r, c, (rng.random(len(r)) + 0.5).astype(
            np.float32), n, n, type=gt.FP32, sum_duplicates=False,
            device=DEV)
    Lv, Uv, M = valued(L), valued(U), valued(L)
    sr = gt.semiring.plus_times[gt.FP32]
    plan = tvd.build_valdot_plan(M, Lv, Uv, sr, min_lanes=1, level_cols=32,
                                 max_levels=3)
    assert plan is not None and plan.A_light.nvals
    M._options[("valdot_plan", "FP32", "FP32")] = (
        *(lambda x=x: x for x in (Lv.indices, Lv.values, Uv.indices,
                                  Uv.values)), plan)
    tvd.valdot_masked_spgemm(sr, Lv, Uv, M)
    counters.reset()
    tvd.valdot_masked_spgemm(sr, Lv, Uv, M)
    assert gt.last_axb_method() == "valdot:hybrid"
    st = counters.stats()
    live = [lv.nlive for lv in plan.levels if lv.nlive]
    assert st["counts"] == {"plan.valdot.reused": 1, "plan.esc.reused": 1,
                            "valdot.slabs": len(live),
                            "valdot.lanes": sum(live), "reads": 1,
                            "esc.sorted_lanes": plan.light_lanes}
    assert {"gb.engines.valdot_slabs", "gb.engines.esc",
            "gb.engines.valdot_combine", "gb.read.valdot_nnz"} == set(
        st["spans"])


def test_from_coo_spans_and_bytes(spans_on):
    I = np.array([3, 1, 2, 1])
    J = np.array([0, 2, 2, 0])
    A = gt.csr_from_coo(I, J, np.ones(4, np.float32), 4, 4, device=DEV)
    st = counters.stats()
    assert st["counts"]["h2d_bytes"] == sum(
        x.numel() * x.element_size()
        for x in (A.indptr, A.indices, A.rowids, A.values))
    recs = {r.name: r for r in counters.span_records()}
    root = recs["gb.containers.from_coo"]
    assert root.parent is None
    assert recs["gb.containers.sort"].parent == root.id
    assert recs["gb.containers.copy"].parent == root.id


def test_trace_holds_entry_spans(tmp_path):
    """Under ``utils.timer.trace`` (a profiler) the spans turn on by
    themselves and reach the Chrome trace as annotations; a read's span
    is kept in memory only."""
    counters.reset()
    L, U = _wathen_lu(8)
    with timer.trace(str(tmp_path)):
        gt.tricount_auto(L, U)
    gt.tricount_auto(L, U)      # no profiler: not recorded
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"gb.entry.tricount_auto", "gb.engines.band_ring"} <= names
    assert not any(n.startswith("gb.read.") for n in names)
    st = counters.stats()["spans"]
    assert st["gb.entry.tricount_auto"]["count"] == 1
    assert st["gb.read.tri_count"]["count"] == 1
    counters.reset()
