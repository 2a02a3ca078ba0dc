"""Timing + profiling utilities.

Counterpart of ``graphblas_tpu/utils/timer.py``.  Reference:
``Demo/Source/simple_timer.c`` (the only profiling tool the reference
ships) plus the per-matrix ``AxB_method_used`` introspection.  Here:
the same tic/toc surface, a context-manager timer whose interval ends
after the card has finished the work queued in it, and a
``torch.profiler`` trace capture written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["simple_tic", "simple_toc", "device_timer", "trace"]

_tic = [0.0]


def simple_tic() -> float:
    """Start the global timer (``simple_tic``)."""
    _tic[0] = time.perf_counter()
    return _tic[0]


def simple_toc() -> float:
    """Seconds since the last :func:`simple_tic` (``simple_toc``)."""
    return time.perf_counter() - _tic[0]


@contextlib.contextmanager
def device_timer(result_holder: Optional[dict] = None):
    """Times a block including device completion:

        with device_timer() as t: y = f(x)
        print(t["s"])

    The interval ends with ``torch.cuda.synchronize()`` when a card is
    in use, so work queued on it inside the block is counted; on the
    CPU the block's own time is the work's."""
    holder = result_holder if result_holder is not None else {}
    t0 = time.perf_counter()
    yield holder
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    holder["s"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace capture of the block (CPU, and CUDA when
    a card is in use), written to ``logdir/trace.json`` as a Chrome
    trace (view in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
