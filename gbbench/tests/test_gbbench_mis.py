"""The ``kron18-mis`` cell: a run at its test size on the CPU is correct
and each fault planted under its timed path turns ``correct`` false,
its bfloat16 control fails at the control's size, its compulsory bytes
are the graph's pattern and the set, the reference's own stream equals
the reference demos' generator, and the two readers of its spans
(``score_span_ms``, ``ewise_span_ms``) read the right milliseconds from
hand-made records and nothing where those spans are missing."""

import time

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from gbbench import control, harness
from gbbench.reference import mis as ref
from graphblas_tpu_torch.core.matrix import Vector
from graphblas_tpu_torch.utils import counters
from graphblas_tpu_torch.utils.counters import SpanRecord
from graphblas_tpu_torch.utils.simple_rand import SimpleRand

BENCH = harness.load_benchmark()
CELL = "kron18-mis"
READERS = ("score_span_ms", "ewise_span_ms")


def small_cfg(sizes: str) -> dict:
    cfg = harness.load_json("configs", harness.cell_of(BENCH,
                                                       CELL)["config"])
    return dict(cfg, **cfg[sizes])


def run_small(trace: bool = False, seed: int = 2**31 + 41):
    return harness.run_cell(BENCH, harness.cell_of(BENCH, CELL), seed, 0.2,
                            trace, "cpu", time.perf_counter(),
                            cfg=small_cfg("test_sizes"))


def test_the_cell_runs_mis_on_the_gap_graph():
    w = harness.cell_of(BENCH, CELL)
    cfg = harness.load_json("configs", w["config"])
    assert (w["chips"], w["traffic"]) == (1, "mis")
    assert cfg["scale"] == 18 and cfg["published"] == {"scale": 27}
    assert cfg["reduced"] == ["scale"]
    kron18 = harness.load_json("configs", "gap-kron-18")
    assert set(cfg) == set(kron18)
    for k in ("graph", "edge_factor", "a", "b", "c", "generator_seed",
              "test_sizes", "card_test_sizes", "control_test_sizes"):
        assert cfg[k] == kron18[k], k
    assert set(kron18["assumed"]) < set(cfg["assumed"])
    assert harness.load_json("traffic", "mis")["seeds"] == 64
    for m in READERS:
        spec = next(x for x in BENCH["per_layer"] if x["name"] == m)
        assert spec["workloads"] == [CELL] and spec["layer"] == "engines"


def test_stream_seeds_from_the_run_seed():
    """64 stream seeds in [1, 2^31), the same for one run seed, others
    for another."""
    entry = harness.load_module("entries", "mis")
    traffic = harness.load_json("traffic", "mis")
    a = entry.make_inputs({}, {}, traffic, 2**40 + 1, "cpu")["seeds"]
    b = entry.make_inputs({}, {}, traffic, 2**40 + 1, "cpu")["seeds"]
    c = entry.make_inputs({}, {}, traffic, 2**40 + 2, "cpu")["seeds"]
    assert a == b != c and len(a) == 64
    assert all(1 <= s < 2**31 for s in a)


@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct(trace):
    line = run_small(trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["run"]["compared"] >= 1
    assert line["checks"] == {k: {"value": 0, "limit": 0}
                              for k in ref.LIMITS}
    if trace:
        m = line["metrics"]
        for name in READERS + ("transpose_span_ms", "spmv_span_ms"):
            assert m[name]["value"] > 0, name
        # one read a call, then two a pass (one in a call's last pass)
        assert m["syncs_per_call"]["value"] >= 4


def _member_flipped(real):
    def fn(A, seed):
        v = real(A, seed).wait()
        pat = v.pattern.clone()
        vals = v.values.clone()
        i = int(torch.nonzero(~(pat & vals))[0])
        pat[i], vals[i] = True, True
        return Vector(vals, pat, v.type)
    return fn


def _singletons_only(real):
    def fn(A, seed):
        deg = A.row_degrees()
        return Vector(deg == 0, deg == 0, gt.BOOL)
    return fn


def _half(real):
    def fn(A, seed):
        keep = torch.arange(A.nzmax) % 2 == 0
        return real(gt.csr_filter_lanes(A, keep), seed)
    return fn


def _another_seed(real):
    def fn(A, seed):
        return real(A, seed + 1)
    return fn


@pytest.mark.parametrize("fault,gap", [
    (_member_flipped, "independence_gap"), (_singletons_only, "maximal_gap"),
    (_half, "independence_gap"), (_another_seed, "set_gap")],
    ids=["answer altered", "state unchanged", "half the batch",
         "another stream"])
def test_fault_turns_correct_false(monkeypatch, fault, gap):
    monkeypatch.setattr(gt.models, "mis", fault(gt.models.mis))
    line = run_small()
    assert line["correct"] is False, line["checks"]
    assert line["checks"][gap]["value"] > 0
    assert line["checks"]["set_gap"]["value"] > 0


def test_control_fails():
    rec = control.readings(harness.cell_of(BENCH, CELL), 2**31 + 43, "cpu",
                           small_cfg("control_test_sizes"))
    assert rec["control_fails"], rec
    assert rec["numbers"]["set_gap"] > 0


@pytest.mark.parametrize("seed", [1, 2**31 + 41, 2**64 - 1])
@pytest.mark.parametrize("k", [1, 3, 500])
def test_reference_stream_is_simple_rand(seed, k):
    """The reference's jump-ahead stream, two passes, against the
    scalar generator of the reference demos."""
    maps = ref.stream_maps(5 * k)
    mine, theirs = ref.Stream(seed), SimpleRand(seed)
    for _ in range(2):
        got = mine.draws(k, maps)
        want = np.array([theirs.rand_x() for _ in range(k)])
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert mine.state == int(theirs.state)


def test_roofline_bytes():
    roof = harness.load_module("roofline", "mis")
    n, nnz = 1 << 18, 7_610_012
    assert roof.compulsory_bytes({"n": n, "nnz": nnz}) == \
        4 * (n + 1) + 4 * nnz + n


def rec(i, name, start, end, parent=None, root=None):
    return SpanRecord(i, parent, root or i, name, start, end, 1)


#: a call before the window, then two: spans in ns
RECORDS = [
    rec(1, "gb.entry.mis", 0, 10_000),
    rec(2, "gb.engines.mis_score", 100, 2_100, 1, 1),
    rec(3, "gb.entry.mis", 20_000, 40_000),
    rec(4, "gb.engines.mis_score", 20_100, 23_100, 3, 3),
    rec(5, "gb.engines.ewise", 21_000, 22_000, 4, 3),
    rec(6, "gb.engines.ewise", 24_000, 26_000, 3, 3),
    rec(7, "gb.entry.mis", 50_000, 60_000),
    rec(8, "gb.engines.mis_score", 50_100, 51_100, 7, 7),
    rec(9, "gb.engines.ewise", 52_000, 56_000, 7, 7),
    rec(10, "gb.read.mis_nvals", 56_100, 56_200, 7, 7),
    rec(11, "gb.engines.ewise", 70_000, 99_000),
]


@pytest.mark.parametrize("name,want", [("score_span_ms", 2e-3),
                                       ("ewise_span_ms", 3.5e-3)])
def test_readers_on_hand_made_records(monkeypatch, name, want):
    """The window's two calls: scores of 3 and 1 us; element-wise spans
    of 1 (inside the first scores), 2 and 4 us; the first call's, and a
    span outside every call, left out."""
    monkeypatch.setattr(counters, "span_records", lambda: RECORDS)
    reader = harness.load_module("metrics", name)
    ctx = {"trace": {"calls": 2}, "calls": 2}
    assert reader.read(ctx) == pytest.approx(want)
    assert reader.read(dict(ctx, trace=None)) is None
    # more calls than the records hold
    assert reader.read(dict(ctx, calls=4)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_spans(monkeypatch, name):
    """Records of a port whose ``mis`` opens no entry span read
    nothing; a port without spans at all reads nothing and raises
    nothing."""
    reader = harness.load_module("metrics", name)
    ctx = {"trace": {"calls": 2}, "calls": 2}
    bare = [r for r in RECORDS if not r.name.startswith("gb.entry.")]
    monkeypatch.setattr(counters, "span_records", lambda: bare)
    assert reader.read(ctx) is None
    monkeypatch.delattr(counters, "span_records")
    assert reader.read(ctx) is None
