"""The readers of the port's own spans (``gbbench/port_spans.py``): the
card's idle time inside calls put down to the port's spans on a
hand-made Chrome trace, the set-up figures and the reads a call from
hand-made span records, the metrics that read them on a port without
spans, and one run of the report on the CPU."""

import json

import pytest
from test_gbbench_trace import EVENTS, ev

from gbbench import harness, port_spans, trace
from graphblas_tpu_torch.utils.counters import SpanRecord

METRICS = [harness.load_module("metrics", name) for name in
           ("syncs_per_call", "plan_span_ms", "engine_span_ms")]

#: the port's spans over EVENTS' two calls (100-200, 250-300): an engine
#: over nonzero's idle 120-150, a read in the idle 180-199, and another
#: thread's span that the calling thread's idle never goes to
SPANS = [
    ev("user_annotation", "gb.entry.tricount_auto", 100, 100),
    ev("user_annotation", "gb.engines.sort_merge", 110, 40),
    ev("user_annotation", "gb.read.tri_count", 180, 19),
    ev("user_annotation", "gb.engines.other_thread", 100, 200, tid=2),
]


def test_idle_goes_to_the_innermost_span():
    idle, total = port_spans.idle_by_span(EVENTS + SPANS)
    # idle inside calls: 120-150, 180-200 and 250-260
    assert total == pytest.approx(60)
    assert idle == {"gb.engines.sort_merge": pytest.approx(30),
                    "gb.entry.tricount_auto": pytest.approx(20),
                    "(none)": pytest.approx(10)}
    assert sum(idle.values()) == pytest.approx(total)


def test_idle_in_a_read_goes_to_its_layer():
    events = [ev("user_annotation", "gbbench.call", 0, 100),
              ev("user_annotation", "gb.entry.mxm", 0, 100),
              ev("user_annotation", "gb.engines.esc", 10, 50),
              ev("user_annotation", "gb.read.esc_nnz", 30, 20),
              ev("user_annotation", "gb.planning.flopcount", 60, 10),
              ev("kernel", "k", 10, 20, tid=7),
              ev("gpu_memset", "Memset", 90, 5, tid=7)]
    idle, total = port_spans.idle_by_span(events)
    assert total == pytest.approx(100 - 20 - 5)
    assert idle == {"gb.entry.mxm": pytest.approx(10 + 20 + 10 - 5),
                    "gb.engines.esc": pytest.approx(30),
                    "gb.planning.flopcount": pytest.approx(10)}
    assert port_spans.layer_idle_ms(idle, 1, "gb.engines.") == \
        pytest.approx(0.03)


def test_idle_outside_every_span_is_none():
    events = [ev("user_annotation", "gbbench.call", 0, 50),
              ev("user_annotation", "gbbench.call", 60, 40),
              ev("user_annotation", "gb.entry.bfs_csr", 60, 40),
              ev("kernel", "k", 40, 30, tid=7)]
    idle, total = port_spans.idle_by_span(events)
    # 0-40 in no span, 70-100 in the entry; 50-60 lies between calls
    assert idle == {"(none)": pytest.approx(40),
                    "gb.entry.bfs_csr": pytest.approx(30)}
    assert total == pytest.approx(70)
    assert port_spans.idle_by_span([ev("kernel", "k", 0, 1)]) == ({}, 0.0)


def test_spans_leave_the_trace_summary_unchanged():
    """The port's annotations change nothing the harness's trace reader
    reports: busy time, idle gaps, device operations, the check."""
    launches = {"bitdot_popcount": 2}
    assert trace.summarise(EVENTS + SPANS, launches) == \
        trace.summarise(EVENTS, launches)


def rec(i, name, start, end, parent=None, root=None):
    return SpanRecord(i, parent, root or i, name, start, end, 1)


#: set-up (a build and a prep), then two calls
RECORDS = [
    rec(1, "gb.containers.from_coo", 0, 100),
    rec(2, "gb.containers.sort", 10, 60, 1, 1),
    rec(3, "gb.read.host_rows", 20, 30, 2, 1),
    rec(4, "gb.containers.copy", 60, 90, 1, 1),
    rec(5, "gb.entry.tricount_auto", 200, 400),
    rec(6, "gb.planning.bitdot_plan", 210, 350, 5, 5),
    rec(7, "gb.planning.esc_plan", 220, 240, 6, 5),
    rec(8, "gb.read.tri_count", 360, 370, 5, 5),
    rec(9, "gb.entry.tricount_auto", 500, 600),
    rec(10, "gb.read.sort_merge_lanes", 510, 520, 9, 9),
    rec(11, "gb.read.tri_count", 580, 590, 9, 9),
    rec(12, "gb.entry.tricount_auto", 700, 800),
    rec(13, "gb.read.tri_count", 780, 790, 12, 12),
    rec(14, "gb.planning.flopcount", 530, 560, 9, 9),
    rec(15, "gb.planning.valdot_plan", 540, 550, 14, 9),
]


def test_setup_figures_and_reads_a_call():
    # the window: the last two calls; the first call is set-up
    fig = port_spans.setup_figures(RECORDS, 2)
    assert fig["sort_s"] == pytest.approx(40e-9)   # 50 less its read
    assert fig["plan_build_s"] == pytest.approx(140e-9)  # nested esc once
    assert port_spans.read_spans_per_call(2, RECORDS) == 1.5
    assert port_spans.read_spans_per_call(3, RECORDS) == pytest.approx(
        4 / 3)
    assert port_spans.read_spans_per_call(4, RECORDS) is None
    assert port_spans.setup_figures(RECORDS, 4) is None


def test_span_time_a_call():
    # the planning spans of the window's calls, the nested one once
    assert port_spans.span_ms_per_call(2, "gb.planning.", RECORDS) == \
        pytest.approx(30e-6 / 2)
    # the first call's plan build lies in a window of three
    assert port_spans.span_ms_per_call(3, "gb.planning.", RECORDS) == \
        pytest.approx(170e-6 / 3)
    assert port_spans.span_ms_per_call(2, "gb.engines.", RECORDS) == 0
    assert port_spans.span_ms_per_call(4, "gb.engines.", RECORDS) is None


def test_metrics_on_a_port_without_spans(monkeypatch):
    import graphblas_tpu_torch.utils.counters as counters
    ctx = {"trace": {"calls": 2}, "calls": 2}
    monkeypatch.delattr(counters, "span_records")
    for metric in METRICS:
        assert metric.read(ctx) is None
        assert metric.read(dict(ctx, trace=None)) is None


def test_report_on_the_cpu(capsys):
    """One traced run of a count cell at its test size with the port's
    spans on from the start: the set-up figures within the harness's
    spans around the same work."""
    assert port_spans.main(["--workload", "kron20-tc", "--seed",
                            str(2**31 + 5), "--seconds", "0.2",
                            "--device", "cpu", "--sizes",
                            "test_sizes"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port, m = out["port"], out["line"]["metrics"]
    assert out["line"]["correct"]
    assert port["syncs_per_call"] == m["syncs_per_call"]["value"] >= 1
    assert 0 < port["sort_s"] <= m["build_s"]["value"] + m["prep_s"][
        "value"]
    assert 0 < port["plan_build_s"] <= (m["first_call_s"]["value"]
                                        + m["prep_s"]["value"])
    assert port["window_counts"]["reads"] == port["syncs_per_call"]
    assert sum(v for _, v in port["idle_by_span_ms"]) <= \
        port["idle_in_calls_ms"] * (1 + 1e-9)
