"""Per-operation counters, named counts and spans: the observability
surface the reference lacks (SURVEY §5 "Tracing/profiling: none
built-in") and VERDICT round-2 asked for alongside the profiler hook.

A process-global registry counts every GraphBLAS operation dispatched
through the L3 orchestrators, the AxB engine chosen per product (the
``AxB_method_used`` analogue, by histogram), and the modelled flop
traffic when the cost model ran.  Zero device work: bumping a counter
is a dict increment, and recording flops reuses the host-side cost
model inputs — nothing here touches the device stream.

The same registry holds named counts (:func:`count`: device-to-host
reads, bytes copied each way, plan cache hits and builds, slabs and
lanes) and spans (:func:`span`, :func:`spanned`).  A span is named
``gb.<layer>.<what>`` after the layer it times (``entry``,
``containers``, ``planning``, ``engines``, ``read``) and records, in
memory, its parent, its start and end by ``perf_counter_ns``, its
thread and the id of the outermost span it runs in (the call's root:
every span of one call shares it).  Spans are off unless a
``torch.profiler`` session is recording or :func:`trace_spans` turned
them on; off costs one flag test and returns a shared null context.
Under a recording profiler a span also opens a profiler annotation of
its name, so the Chrome trace shows it as a ``user_annotation`` on the
kernels' clock.  Every device-to-host read on the main paths goes
through :func:`host_read`, which counts it and spans it as
``gb.read.<site>``.

Usage::

    from graphblas_tpu_torch.utils import counters
    counters.reset()
    ... run GraphBLAS ops ...
    counters.stats()   # {'ops': {'mxm': 3, ...},
                       #  'axb_methods': {'esc': 2, 'mxu': 1},
                       #  'modelled_flops': 123456,
                       #  'counts': {'reads': 6, ...},
                       #  'spans': {'gb.entry.mxm': {'count': 3,
                       #            'total_s': ..., 'self_s': ...}}}
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["bump", "add_flops", "record_method", "stats", "reset",
           "enabled", "enable", "counted", "count", "span", "spanned",
           "host_read", "to_device", "trace_spans",
           "span_records", "SpanRecord"]

_lock = threading.Lock()
_state = {
    "ops": {},           # op name -> dispatch count
    "axb_methods": {},   # engine name -> count
    "modelled_flops": 0,  # cumulative cost-model flops
    "counts": {},        # named count -> total
    "enabled": True,
}


def enable(on: bool = True) -> None:
    """Turn counting on/off (on by default; the bumps are O(1) host
    dict increments, so leaving it on costs nothing measurable).  Spans
    are governed by :func:`trace_spans` and the profiler instead."""
    _state["enabled"] = bool(on)


def enabled() -> bool:
    return _state["enabled"]


def bump(op: str, n: int = 1) -> None:
    """Count one dispatch of the named operation."""
    if not _state["enabled"]:
        return
    with _lock:
        _state["ops"][op] = _state["ops"].get(op, 0) + n


def record_method(method: str) -> None:
    """Histogram the AxB engine choice (AxB_method_used analogue)."""
    if not _state["enabled"]:
        return
    with _lock:
        _state["axb_methods"][method] = \
            _state["axb_methods"].get(method, 0) + 1


def add_flops(n: int) -> None:
    """Accumulate modelled flops (from the AxB cost model)."""
    if not _state["enabled"]:
        return
    with _lock:
        _state["modelled_flops"] += int(n)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the named count (``reads``, ``d2h_bytes``,
    ``h2d_bytes``, ``plan.<name>.built`` / ``.reused``,
    ``valdot.slabs``, ``valdot.lanes``, ``flopcount.exact``)."""
    if not _state["enabled"]:
        return
    with _lock:
        _state["counts"][name] = _state["counts"].get(name, 0) + int(n)


# -- spans -----------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One finished span; times by ``time.perf_counter_ns``."""
    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int
    thread: int


#: the spans kept (the oldest are dropped past this many)
MAX_RECORDS = 1 << 20

_forced = [False]
_records: deque = deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()
_now = time.perf_counter_ns
_thread = threading.get_ident
_profiling = torch._C._autograd._profiler_enabled
# the profiler's user annotation without record_function's operator
# dispatch (cheaper by a third to three quarters); record_function where
# torch lacks it
_annotate = getattr(torch._C._autograd, "_record_function_with_args_enter",
                    None)
_annotate_end = getattr(torch._C._autograd,
                        "_record_function_with_args_exit", None)


def trace_spans(on: bool = True) -> None:
    """Record spans whether or not a profiler is recording (off by
    default)."""
    _forced[0] = bool(on)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "mark")
    annotated = True

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.mark = None
        if self.annotated and _profiling():
            if _annotate is not None:
                self.mark = _annotate(self.name)
            else:
                self.mark = torch.profiler.record_function(self.name)
                self.mark.__enter__()
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        if self.mark is not None:
            if _annotate is not None:
                _annotate_end(self.mark)
            else:
                self.mark.__exit__(None, None, None)
        _local.stack.pop()
        rec = (self.id, self.parent, self.root, self.name, self.start, end,
               _thread())
        with _lock:
            _records.append(rec)
        return False


class _ReadSpan(_Span):
    """A read's span, kept in memory only: the card's idle time inside a
    read belongs to the layer that reads, and an annotation around a
    wait on the card would only lengthen it."""
    __slots__ = ()
    annotated = False


def span(name: str):
    """A context manager timing its block as the span ``name`` while
    a profiler records or :func:`trace_spans` turned spans on; a shared
    null context otherwise."""
    if _forced[0] or _profiling():
        return _Span(name)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_forced[0] or _profiling()):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def host_read(t: torch.Tensor, site: str, to=int):
    """Read ``t`` back to the host as ``to(t)`` (``int`` or ``bool`` of
    a one-element tensor) or, with ``to=np.ndarray``, as a host array
    (its bytes counted in ``d2h_bytes``), inside the span
    ``gb.read.<site>`` (in memory; the profiler's trace does not show
    it).  Counts one ``reads`` on any device, so the CPU tests pin the
    count the card makes."""
    count("reads")
    on = _forced[0] or _profiling()
    with _ReadSpan("gb.read." + site) if on else _NULL:
        if to is np.ndarray:
            out = t.cpu().numpy()
        else:
            return to(t)
    count("d2h_bytes", out.nbytes)
    return out


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``torch.from_numpy(a).to(device)``, its bytes counted in
    ``h2d_bytes`` (on any device, as :func:`host_read`)."""
    count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


def span_records() -> List[SpanRecord]:
    """The finished spans kept, oldest first."""
    with _lock:
        return list(map(SpanRecord._make, _records))


def _span_stats(records) -> Dict:
    """Per span name: count, total and self seconds (self: the span's
    time less its children's)."""
    child = {}
    for r in records:
        if r.parent is not None:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    out = {}
    for r in records:
        d = r.end_ns - r.start_ns
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += d / 1e9
        s["self_s"] += (d - child.get(r.id, 0)) / 1e9
    return out


def stats() -> Dict:
    """Snapshot of all counters, the named counts and the spans."""
    with _lock:
        snap = {"ops": dict(_state["ops"]),
                "axb_methods": dict(_state["axb_methods"]),
                "modelled_flops": _state["modelled_flops"],
                "counts": dict(_state["counts"])}
    snap["spans"] = _span_stats(span_records())
    return snap


def reset() -> None:
    with _lock:
        _state["ops"].clear()
        _state["axb_methods"].clear()
        _state["modelled_flops"] = 0
        _state["counts"].clear()
        _records.clear()


def counted(name: str):
    """Decorator: count each call of an L3 orchestrator under ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bump(name)
            return fn(*args, **kwargs)
        return wrapper
    return deco
