"""The port's own spans and counts, read beside a run of a cell.

``graphblas_tpu_torch.utils.counters`` records a span ``gb.<layer>.<what>``
at each layer of the port while a profiler records (and from the start
with ``trace_spans(True)``), and shows it in the profiler's trace as a
``user_annotation`` on the kernels' clock.  This module reads them:

- ``read_spans_per_call``: the ``gb.read.*`` spans of a window's calls
  (the ``syncs_per_call`` metric);
- ``span_ms_per_call``: the host time of a window's calls inside one
  layer's spans (``plan_span_ms``, ``engine_span_ms``);
- ``setup_figures``: the self time of ``gb.containers.sort`` and the
  time of the plan builds (``gb.planning.*_plan``) before the window;
- ``idle_by_span``: the card's idle time inside calls, each piece put
  down to the innermost ``gb.*`` span around it that is not a read;
- ``main``: one traced run of a cell with the port's spans on from the
  start, printing those figures beside the result line::

      python3 gbbench/port_spans.py --workload <cell> --seed <n> \\
          --seconds <s> [--device cuda:0] [--sizes test_sizes]

  (``--sizes``: the configuration's sizes under that key, as the
  benchmark's own tests run it).

Every reader returns nothing, and raises nothing, on a port that
records no spans.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ENTRY = "gb.entry."
READ = "gb.read."
PLAN_BUILDS = ("gb.planning.valdot_plan", "gb.planning.esc_plan",
               "gb.planning.bitdot_plan", "gb.planning.band_plan",
               "gb.planning.window_plan")
NONE = "(none)"
TOP = 10


def _records():
    try:
        from graphblas_tpu_torch.utils.counters import span_records
    except ImportError:
        return None
    return span_records()


def window_roots(records, calls: int):
    """The ids of the last ``calls`` outermost ``gb.entry.*`` spans (the
    window's calls), or None when fewer were recorded."""
    roots = [r.id for r in records
             if r.parent is None and r.name.startswith(ENTRY)][-calls:]
    return roots if calls and len(roots) == calls else None


def read_spans_per_call(calls: int, records=None):
    records = _records() if records is None else records
    if records is None:
        return None
    roots = window_roots(records, calls)
    if roots is None:
        return None
    roots = set(roots)
    reads = sum(1 for r in records
                if r.root in roots and r.name.startswith(READ))
    return reads / calls


def span_ms_per_call(calls: int, prefix: str, records=None):
    """Milliseconds a call of the window's calls inside the spans whose
    names begin with ``prefix`` (those inside another such span counted
    once, with it)."""
    records = _records() if records is None else records
    if records is None:
        return None
    roots = window_roots(records, calls)
    if roots is None:
        return None
    roots = set(roots)
    mine = {r.id: r for r in records
            if r.root in roots and r.name.startswith(prefix)}
    ns = sum(r.end_ns - r.start_ns for r in mine.values()
             if r.parent not in mine)
    return ns / 1e6 / calls


def setup_figures(records, calls: int):
    """{sort_s, plan_build_s} of the spans that ended before the
    window's first call began; None without the window's calls."""
    roots = window_roots(records, calls)
    if roots is None:
        return None
    first = next(r for r in records if r.id == roots[0])
    setup = [r for r in records if r.end_ns <= first.start_ns]
    child = {}
    for r in setup:
        if r.parent is not None:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    by_id = {r.id: r for r in setup}

    def under_build(r):
        p = by_id.get(r.parent)
        while p is not None:
            if p.name in PLAN_BUILDS:
                return True
            p = by_id.get(p.parent)
        return False
    sort_ns = sum(r.end_ns - r.start_ns - child.get(r.id, 0)
                  for r in setup if r.name == "gb.containers.sort")
    build_ns = sum(r.end_ns - r.start_ns for r in setup
                   if r.name in PLAN_BUILDS and not under_build(r))
    return {"sort_s": sort_ns / 1e9, "plan_build_s": build_ns / 1e9}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(events: list, call_name: str = "gbbench.call",
                 device_cats=("kernel", "gpu_memcpy", "gpu_memset")):
    """The card's idle time inside calls (trace microseconds), by the
    innermost ``gb.*`` span on the calling thread that is not a read
    (``(none)`` outside every such span): ({label: idle_us}, the idle
    time inside calls, which the pieces sum to)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]

    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    marks = [e for e in xs if e.get("cat") == "user_annotation"
             and e.get("name") == call_name]
    if not marks:
        return {}, 0.0
    tid = marks[0].get("tid")
    # one sweep over every edge: at equal times the ends come first
    edges = []
    for kind, ivs in (("call", _union(iv(e) for e in marks)),
                      ("busy", _union(iv(e) for e in xs
                                      if e.get("cat") in device_cats))):
        for a, b in ivs:
            edges += [(a, 1, kind, None), (b, 0, kind, None)]
    for e in xs:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and e.get("tid") == tid
                and name.startswith("gb.") and not name.startswith(READ)):
            a, b = iv(e)
            # the longer of two spans begun together is the outer one
            edges += [(a, 1, "span", (-b, name)), (b, 0, "span", (-b, name))]
    edges.sort(key=lambda x: (x[0], x[1], x[3] or (0, "")))
    idle, total = {}, 0.0
    state = {"call": 0, "busy": 0}
    stack = []
    t = edges[0][0]
    for at, up, kind, key in edges:
        if at > t and state["call"] and not state["busy"]:
            label = stack[-1][1] if stack else NONE
            idle[label] = idle.get(label, 0.0) + (at - t)
            total += at - t
        t = at
        if kind != "span":
            state[kind] += 1 if up else -1
        elif up:
            stack.append(key)
        elif key in stack:
            stack.remove(key)
    return idle, total


def layer_idle_ms(idle: dict, calls: int, prefix: str) -> float:
    """Idle milliseconds a call under the spans named ``prefix``*."""
    return sum(v for k, v in idle.items() if k.startswith(prefix)) \
        / 1e3 / calls


def main(argv=None) -> int:
    import argparse
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gbbench import harness
    from gbbench import trace as tr
    from graphblas_tpu_torch.utils import counters

    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--sizes")
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    if args.sizes:
        cfg = dict(cfg, **cfg[args.sizes])

    # the trace's events and the counts at the window's two ends, taken
    # where the harness reads its launch counter and summarises the trace
    kept = {"counts": []}
    summarise, launch_counts = tr.summarise, harness.launch_counts

    def keep_events(events, launches):
        kept["events"] = events
        return summarise(events, launches)

    def keep_counts():
        kept["counts"].append(counters.stats()["counts"])
        return launch_counts()
    tr.summarise, harness.launch_counts = keep_events, keep_counts
    counters.reset()
    counters.trace_spans(True)
    try:
        line = harness.run_cell(bench, cell, args.seed, args.seconds, True,
                                args.device, t0, cfg=cfg)
    finally:
        tr.summarise, harness.launch_counts = summarise, launch_counts
        counters.trace_spans(False)
    calls = line["attempted"]
    records = counters.span_records()
    c0, c1 = kept["counts"][:2]
    port = {"window_counts": {k: (v - c0.get(k, 0)) / calls
                              for k, v in c1.items() if v != c0.get(k, 0)},
            "syncs_per_call": read_spans_per_call(calls, records),
            **(setup_figures(records, calls) or {})}
    idle, total = idle_by_span(kept.get("events", []))
    if total:
        port.update({
            "idle_in_calls_ms": total / 1e3 / calls,
            "span_idle_share": 1 - idle.get(NONE, 0.0) / total,
            "plan_idle_ms": layer_idle_ms(idle, calls, "gb.planning."),
            "engine_idle_ms": layer_idle_ms(idle, calls, "gb.engines."),
            "idle_by_span_ms": [[k, v / 1e3 / calls] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]})
    st = counters.stats()["spans"]
    port["spans_per_call"] = sum(
        1 for r in records if r.root in set(window_roots(records, calls)
                                            or ())) / calls
    port["span_self_s"] = {k: v["self_s"] for k, v in sorted(
        st.items(), key=lambda kv: -kv[1]["self_s"])[:TOP]}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "port": port, "line": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
