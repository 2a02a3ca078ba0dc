"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, read from its Chrome trace.

``stop`` returns the device's busy seconds (the union of every kernel,
copy and fill on the card) inside the traced window (the first call's
start to the last call's end, by the harness's ``gbbench.call``
annotations), the calls traced, the profiler's count of the port's
hand-written kernels beside the port's own launch counter, and the
breakdown: the device operations that took most time, and the idle time
by what the host was doing.

The port launches its kernels through ctypes, outside every PyTorch
operator; PyTorch launches its own inside one.  So a kernel is the
port's when its launch call (the runtime or driver event of the same
correlation id) ran outside every ``cpu_op`` of its thread, or the trace
holds no launch call for it.  That needs neither the port's sources nor
its kernels' names.  The check holds when the trace has every launch the
counter has but at most a ``MISSED`` share, and none it lacks.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from pathlib import Path

import torch

CALL = "gbbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the share of a kernel's launches the trace may lack: CUPTI was seen
#: to drop 1-15 of some 6,000 K1 records at thousands of calls a second
MISSED = 1e-3
TOP = 10
NAME_CHARS = 160


def start(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                  profile_memory=False, with_stack=False)
    prof.start()
    return prof


def stop(prof, launches: dict) -> dict:
    """Stop ``prof``, read its trace (written to TMPDIR and removed) and
    summarise it; ``launches`` is the port's launch counter's change
    over the same window."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gbbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    return summarise(events, launches)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarise(events: list, launches: dict) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("tid"))
                   for e in xs if e.get("cat") == "user_annotation"
                   and e.get("name") == CALL)
    if not calls:
        raise RuntimeError("the trace holds no gbbench.call span")
    w0, w1 = calls[0][0], max(c[1] for c in calls)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _union((max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev)
    busy_us = sum(e - s for s, e in busy)

    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    device_ops = [[n[:NAME_CHARS], t / 1e6] for n, t in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    check = _check_port_kernels(xs, [e for e in dev
                                     if e.get("cat") == "kernel"], launches)
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "calls": len(calls), "check": check,
            "breakdown": {"device_ops": device_ops,
                          "idle_gaps": _idle_by_host(xs, busy, calls,
                                                     w0, w1)}}


def _check_port_kernels(xs, kernels, launches: dict) -> dict:
    """The traced kernels that no PyTorch operator launched, against the
    change of the port's launch counter over the same window."""
    launch_at = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (float(e["ts"]), e.get("tid"))
    # per thread: operators by start, and the latest end of any operator
    # begun so far; a point lies inside an operator when that end is past it
    ops = {}
    for e in xs:
        if e.get("cat") == "cpu_op":
            ops.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    reach = {}
    for tid, spans in ops.items():
        spans.sort()
        ends, far = [], float("-inf")
        for _, e in spans:
            far = max(far, e)
            ends.append(far)
        reach[tid] = ([s for s, _ in spans], ends)

    def in_operator(ts, tid):
        starts, ends = reach.get(tid, ((), ()))
        k = bisect.bisect_right(starts, ts) - 1
        return k >= 0 and ends[k] > ts

    port = {}
    unlaunched = 0
    for e in kernels:
        at = launch_at.get((e.get("args") or {}).get("correlation"))
        if at is None:
            unlaunched += 1
        elif in_operator(*at):
            continue
        name = e["name"][:NAME_CHARS]
        port[name] = port.get(name, 0) + 1
    traced = sum(port.values())
    counted = int(sum(launches.values()))
    ok = traced <= counted <= traced + MISSED * counted
    check = {"ok": ok, "launches": counted, "traced": traced,
             "traced_without_launch_call": unlaunched,
             "port_kernels": dict(sorted(port.items(),
                                         key=lambda kv: -kv[1])[:TOP]),
             "launches_by_launcher": {k: int(v) for k, v in
                                      launches.items() if v}}
    if not ok:
        check["reason"] = (
            f"the trace holds {traced} kernels launched outside any "
            f"PyTorch operator; the port's launch counter moved by "
            f"{counted}")
    return check


def _idle_by_host(xs, busy, calls, w0, w1) -> list:
    """The window's idle device time summed by what the host was doing:
    each gap cut where a call starts or ends, and each piece labelled
    "between calls", or "call" with the innermost
    PyTorch operation running on the calling thread as the piece began
    ("call/host" where none ran: Python or numpy work)."""
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    # cut each gap where a call starts or ends
    cuts = sorted({t for c in calls for t in c[:2]})
    pieces = []
    for g0, g1 in gaps:
        a = bisect.bisect_right(cuts, g0)
        b = bisect.bisect_left(cuts, g1)
        edges = [g0, *cuts[a:b], g1]
        pieces.extend(zip(edges[:-1], edges[1:]))
    tid = calls[0][2]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in xs
                 if e.get("cat") == "cpu_op" and e.get("tid") == tid)
    op_starts = [o[0] for o in ops]
    call_starts = [c[0] for c in calls]
    idle = {}
    for g0, g1 in pieces:
        k = bisect.bisect_right(call_starts, g0) - 1
        if k < 0 or calls[k][1] <= g0:
            label = "between calls"
        else:
            label = "call/host"
            j = bisect.bisect_right(op_starts, g0) - 1
            for back in range(j, max(j - 400, -1), -1):
                s, e, name = ops[back]
                if s < calls[k][0]:
                    break
                if e >= g0:
                    label = f"call/{name}"
                    break
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    return [[n[:NAME_CHARS], t / 1e6] for n, t in
            sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]
