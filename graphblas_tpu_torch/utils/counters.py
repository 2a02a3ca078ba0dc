"""Per-operation counters: the observability surface the reference
lacks (SURVEY §5 "Tracing/profiling: none built-in") and VERDICT round-2
asked for alongside the profiler hook.

A process-global registry counts every GraphBLAS operation dispatched
through the L3 orchestrators, the AxB engine chosen per product (the
``AxB_method_used`` analogue, by histogram), and the modelled flop
traffic when the cost model ran.  Zero device work: bumping a counter
is a dict increment, and recording flops reuses the host-side cost
model inputs — nothing here touches the device stream.

Usage::

    from graphblas_tpu_torch.utils import counters
    counters.reset()
    ... run GraphBLAS ops ...
    counters.stats()   # {'ops': {'mxm': 3, ...},
                       #  'axb_methods': {'esc': 2, 'mxu': 1},
                       #  'modelled_flops': 123456}
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["bump", "add_flops", "record_method", "stats", "reset",
           "enabled", "enable", "counted"]

_lock = threading.Lock()
_state = {
    "ops": {},           # op name -> dispatch count
    "axb_methods": {},   # engine name -> count
    "modelled_flops": 0,  # cumulative cost-model flops
    "enabled": True,
}


def enable(on: bool = True) -> None:
    """Turn counting on/off (on by default; the bumps are O(1) host
    dict increments, so leaving it on costs nothing measurable)."""
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


def stats() -> Dict:
    """Snapshot of all counters."""
    with _lock:
        return {"ops": dict(_state["ops"]),
                "axb_methods": dict(_state["axb_methods"]),
                "modelled_flops": _state["modelled_flops"]}


def reset() -> None:
    with _lock:
        _state["ops"].clear()
        _state["axb_methods"].clear()
        _state["modelled_flops"] = 0


def counted(name: str):
    """Decorator: count each call of an L3 orchestrator under ``name``."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bump(name)
            return fn(*args, **kwargs)
        return wrapper
    return deco
