"""The ``kron18-bfs5m`` cell: a run at its test size on the CPU is
correct and each fault planted under its timed path turns ``correct``
false, its control fails, and the two readers of its spans
(``transpose_span_ms``, ``spmv_span_ms``) read the right milliseconds
from hand-made records and nothing where those spans are missing."""

import time

import pytest
import torch

import graphblas_tpu_torch as gt
from gbbench import control, harness
from graphblas_tpu_torch.core.matrix import Vector
from graphblas_tpu_torch.utils import counters
from graphblas_tpu_torch.utils.counters import SpanRecord

BENCH = harness.load_benchmark()
CELL = "kron18-bfs5m"
READERS = ("transpose_span_ms", "spmv_span_ms")


def small_cfg(sizes: str) -> dict:
    cfg = harness.load_json("configs", harness.cell_of(BENCH,
                                                       CELL)["config"])
    return dict(cfg, **cfg[sizes])


def run_small(trace: bool = False, seed: int = 2**31 + 41):
    return harness.run_cell(BENCH, harness.cell_of(BENCH, CELL), seed, 0.2,
                            trace, "cpu", time.perf_counter(),
                            cfg=small_cfg("test_sizes"))


def test_the_cell_runs_bfs5m_on_the_gap_graph():
    w = harness.cell_of(BENCH, CELL)
    cfg = harness.load_json("configs", w["config"])
    assert (w["chips"], w["traffic"]) == (1, "bfs5m")
    assert cfg["scale"] == 18 and cfg["published"] == {"scale": 27}
    assert cfg["reduced"] == ["scale"]
    kron20 = harness.load_json("configs", "gap-kron-20")
    assert set(cfg) - {"why_reduced"} == set(kron20)
    for k in ("edge_factor", "a", "b", "c", "generator_seed", "assumed",
              "test_sizes", "card_test_sizes", "control_test_sizes"):
        assert cfg[k] == kron20[k], k
    assert harness.load_json("traffic", "bfs5m")["sources"] == 64


@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct(trace):
    line = run_small(trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["run"]["compared"] >= 1
    assert line["checks"]["level_gap"] == {"value": 0, "limit": 0}
    if trace:
        m = line["metrics"]
        assert m["transpose_span_ms"]["value"] > 0
        assert m["spmv_span_ms"]["value"] > 0
        # a read a level (the successor flag, with whether the frontier
        # is full) and the first level's dense-frontier test
        assert m["syncs_per_call"]["value"] >= 3


def _levels_bumped(real):
    def fn(A, s):
        v = real(A, s).wait()
        vals = v.values.clone()
        vals[int(vals.argmax())] += 1
        return Vector(vals, v.pattern, v.type)
    return fn


def _unchanged(real):
    def fn(A, s):
        return Vector.new(gt.INT32, A.nrows, device=A.device).setElement(
            1, s)
    return fn


def _half(real):
    def fn(A, s):
        keep = torch.arange(A.nzmax) % 2 == 0
        return real(gt.csr_filter_lanes(A, keep), s)
    return fn


@pytest.mark.parametrize("fault", [_levels_bumped, _unchanged, _half],
                         ids=["answer altered", "state unchanged",
                              "half the batch"])
def test_fault_turns_correct_false(monkeypatch, fault):
    monkeypatch.setattr(gt.models, "bfs5m", fault(gt.models.bfs5m))
    line = run_small()
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["level_gap"]["value"] > 0


def test_control_fails():
    rec = control.readings(harness.cell_of(BENCH, CELL), 2**31 + 43, "cpu",
                           small_cfg("control_test_sizes"))
    assert rec["control_fails"], rec


def rec(i, name, start, end, parent=None, root=None):
    return SpanRecord(i, parent, root or i, name, start, end, 1)


#: a call before the window, then two: spans in ns
RECORDS = [
    rec(1, "gb.entry.bfs5m", 0, 10_000),
    rec(2, "gb.containers.transpose", 100, 2_100, 1, 1),
    rec(3, "gb.entry.bfs5m", 20_000, 40_000),
    rec(4, "gb.containers.transpose", 20_100, 23_100, 3, 3),
    rec(5, "gb.engines.spmv", 24_000, 25_000, 3, 3),
    rec(6, "gb.engines.spmv", 26_000, 28_000, 3, 3),
    rec(7, "gb.entry.bfs5m", 50_000, 60_000),
    rec(8, "gb.containers.transpose", 50_100, 51_100, 7, 7),
    rec(9, "gb.engines.spmv", 52_000, 56_000, 7, 7),
    rec(10, "gb.read.all_present", 52_100, 52_200, 9, 7),
    rec(11, "gb.engines.spmv", 70_000, 99_000),
]


@pytest.mark.parametrize("name,want", [("transpose_span_ms", 2e-3),
                                       ("spmv_span_ms", 3.5e-3)])
def test_readers_on_hand_made_records(monkeypatch, name, want):
    """The window's two calls: transposes of 3 and 1 us, SpMVs of 1, 2
    and 4 us; the first call's, and a span outside every call, left
    out."""
    monkeypatch.setattr(counters, "span_records", lambda: RECORDS)
    reader = harness.load_module("metrics", name)
    ctx = {"trace": {"calls": 2}, "calls": 2}
    assert reader.read(ctx) == pytest.approx(want)
    assert reader.read(dict(ctx, trace=None)) is None
    # more calls than the records hold
    assert reader.read(dict(ctx, calls=4)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_spans(monkeypatch, name):
    """Records of a port whose ``bfs5m`` opens no entry span read
    nothing; a port without spans at all reads nothing and raises
    nothing."""
    reader = harness.load_module("metrics", name)
    ctx = {"trace": {"calls": 2}, "calls": 2}
    bare = [r for r in RECORDS if not r.name.startswith("gb.entry.")]
    monkeypatch.setattr(counters, "span_records", lambda: bare)
    assert reader.read(ctx) is None
    monkeypatch.delattr(counters, "span_records")
    assert reader.read(ctx) is None
