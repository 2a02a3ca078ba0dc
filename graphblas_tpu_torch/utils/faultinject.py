"""Allocation-fault injection — the malloc-debug countdown analogue.

Counterpart of ``graphblas_tpu/utils/faultinject.py`` (a copy: the port
imports nothing of the JAX package).  The reference exhaustively tests
every out-of-memory unwind path with a countdown counter on its malloc
wrapper: when ``malloc_debug_count`` reaches zero the next allocation
pretends to fail, the operation must return ``GrB_OUT_OF_MEMORY``
leaving all objects valid, and the test re-runs with a larger countdown
until it succeeds (``Source/GB.h:2309-2321``, ``Test/README.txt:33-50``).

PyTorch's caching allocator owns device memory, so the faultable unit is
not ``malloc`` but the *container-materialization site*: every point
where a new Matrix / CsrMatrix / HyperMatrix buffer set comes into
existence calls :func:`checkpoint`, with the JAX package's labels.
Under an active countdown the k-th site raises
:class:`~graphblas_tpu_torch.core.errors.OutOfMemory`.  The port's
containers hold tensors, which can be written in place, and a container
shares its tensors with its shallow copies; so "the inputs are
unchanged after an unwind" holds only because no operation writes into
a tensor that one of its inputs holds.  The fault sweeps
(``tests/test_torch_faultinject.py``) check exactly that: inputs
bit-identical after every fault, and the retry equal to the clean run.
"""

from __future__ import annotations

import contextlib
import threading

from ..core.errors import OutOfMemory

__all__ = ["checkpoint", "fault_countdown", "set_fault_countdown",
           "clear_fault", "sites_crossed"]

# thread-local so concurrent user threads don't trip each other's
# countdowns (the reference's counter is global and its tests are
# single-threaded; thread-local is the strictly safer port)
_tls = threading.local()


def set_fault_countdown(k: int) -> None:
    """Arm the countdown: the k-th checkpoint from now raises
    ``OutOfMemory`` (k=1 → the very next one).  The reference's
    ``malloc_debug_count`` setter (``GB.h:2313``)."""
    if k < 1:
        raise ValueError("countdown must be >= 1")
    _tls.count = int(k)
    _tls.crossed = 0


def clear_fault() -> None:
    _tls.count = None
    _tls.crossed = 0


def sites_crossed() -> int:
    """Checkpoints passed since the countdown was last armed (also
    counts while disarmed-after-fire); lets tests size their sweep."""
    return getattr(_tls, "crossed", 0)


@contextlib.contextmanager
def fault_countdown(k: int):
    """``with fault_countdown(3): op()`` — fail the 3rd materialization."""
    set_fault_countdown(k)
    try:
        yield
    finally:
        clear_fault()


def checkpoint(what: str = "") -> None:
    """Declare a container-materialization site.  No-op unless a
    countdown is armed (one attribute read on the fast path)."""
    count = getattr(_tls, "count", None)
    if count is None:
        _tls.crossed = getattr(_tls, "crossed", 0) + 1
        return
    _tls.crossed += 1
    count -= 1
    _tls.count = count
    if count <= 0:
        _tls.count = None  # one-shot, like the reference's countdown
        raise OutOfMemory(f"injected allocation fault at {what or 'site'}")
