"""The trace reader on a hand-made Chrome trace: the busy time, the
breakdown, and the port's kernels told from PyTorch's by where their
launch calls ran."""

import pytest

from gbbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


POPCOUNT = ("void (anonymous namespace)::bitdot_popcount_kernel<true>"
            "(unsigned int const*, int)")
EVENTS = [
    ev("user_annotation", "gbbench.call", 100, 100),
    ev("user_annotation", "gbbench.call", 250, 50),
    ev("cpu_op", "aten::nonzero", 120, 30),
    ev("cpu_op", "aten::sort", 140, 5),
    ev("cpu_op", "aten::item", 180, 19),
    # the port's launch (ctypes, outside every operator), then PyTorch's
    ev("cuda_runtime", "cudaLaunchKernel", 101, 2, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 141, 2, corr=2),
    ev("cuda_runtime", "cudaMemcpyAsync", 181, 2, corr=3),
    ev("kernel", POPCOUNT, 100, 20, tid=7, corr=1),
    ev("kernel", "void at::native::sort_kernel(int*)", 150, 30, tid=7,
       corr=2),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 175, 5, tid=7,
       corr=3),
    # a kernel whose launch call the trace lacks counts as the port's
    ev("kernel", "void (anonymous namespace)::bitdot_popcount_kernel"
       "<false>(unsigned int const*, int)", 260, 40, tid=7, corr=9),
    ev("kernel", "outside the window", 10, 5, tid=7),
]


def test_summary():
    s = trace.summarise(EVENTS, {"bitdot_popcount": 2, "tri_band_ring": 0})
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(90e-6)  # 20 + 30 (a copy in it) + 40
    assert s["calls"] == 2
    c = s["check"]
    assert c["ok"] and "reason" not in c
    assert (c["launches"], c["traced"]) == (2, 2)
    assert c["traced_without_launch_call"] == 1
    assert c["launches_by_launcher"] == {"bitdot_popcount": 2}
    assert sum(c["port_kernels"].values()) == 2
    assert "void at::native::sort_kernel(int*)" not in c["port_kernels"]
    idle = dict(s["breakdown"]["idle_gaps"])
    # 120-150 in nonzero, 180-200 in item, 200-250 between calls
    assert idle["call/aten::nonzero"] == pytest.approx(30e-6)
    assert idle["call/aten::item"] == pytest.approx(20e-6)
    assert idle["between calls"] == pytest.approx(50e-6)
    assert idle["call/host"] == pytest.approx(10e-6)  # 250-260
    ops = s["breakdown"]["device_ops"]
    assert ops[0] == [EVENTS[11]["name"], pytest.approx(40e-6)]
    assert ops[1] == ["void at::native::sort_kernel(int*)",
                      pytest.approx(30e-6)]
    assert "outside the window" not in dict(ops)


@pytest.mark.parametrize("launches", [{"bitdot_popcount": 3},
                                      {"bitdot_popcount": 1},
                                      {}])
def test_summary_flags_a_count_that_disagrees(launches):
    s = trace.summarise(EVENTS, launches)
    assert not s["check"]["ok"]
    assert "launch counter moved by" in s["check"]["reason"]


def test_a_launch_inside_an_operator_is_pytorchs():
    """The same kernel is the port's or PyTorch's by where its launch
    call ran, not by its name."""
    events = [ev("user_annotation", "gbbench.call", 0, 100),
              ev("cpu_op", "aten::index_add_", 10, 20),
              ev("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
              ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
              ev("cuda_runtime", "cudaLaunchKernel", 20, 1, tid=2, corr=3),
              ev("kernel", "k", 16, 5, tid=7, corr=1),
              ev("kernel", "k", 41, 5, tid=7, corr=2),
              ev("kernel", "k", 60, 5, tid=7, corr=3)]
    s = trace.summarise(events, {"some_launcher": 2})
    # corr 1 ran inside index_add_; corr 3 on a thread with no operator
    assert s["check"]["ok"] and s["check"]["port_kernels"] == {"k": 2}


@pytest.mark.parametrize("counted,ok", [(2000, True), (2002, True),
                                        (2003, False), (1999, False)])
def test_summary_allows_a_few_dropped_records(counted, ok):
    """The trace may lack at most a thousandth of the port's launches
    (2 of 2,002), and never hold more than the counter."""
    events = [ev("user_annotation", "gbbench.call", 0, 10000)] + [
        ev("kernel", "tri_band_ring_kernel(signed char const*)", 5 * k, 2,
           tid=7) for k in range(2000)]
    s = trace.summarise(events, {"tri_band_ring": counted})
    assert s["check"]["ok"] is ok
    assert (s["check"]["launches"], s["check"]["traced"]) == (counted, 2000)


def test_summary_needs_calls():
    with pytest.raises(RuntimeError):
        trace.summarise([ev("kernel", "k", 0, 1)], {})
