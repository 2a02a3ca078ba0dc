"""Global / per-call option system.

Counterpart of ``graphblas_tpu/core/options.py``.  Reference: three
scopes (``Include/GraphBLAS.h:2917-2930``) — global
``GxB_Global_Option_set/get`` (HYPER ratio, FORMAT, MODE, NTHREADS),
per-matrix ``GxB_Matrix_Option_set``, per-call descriptors.

The fields are the JAX package's, so a caller's settings carry over:
HYPER ratio is the CSR<->hypersparse conformance threshold; FORMAT
by-row/by-col is the default transpose orientation; MODE
blocking/non-blocking says whether ``setElement`` folds immediately;
NTHREADS and ``chunk`` are block-size hints.  The options are per
thread.

MODE is read by ``setElement`` (every container): in blocking mode a
pending tuple folds at once.  HYPER ratio is read by
``sparse.hyper.hyper_conform`` (the ``GB_to_hyper_conform`` rule) when
a matrix carries no ``hyper_ratio`` option of its own; conformance runs
at the import boundary (``core.io_export``) and wherever a caller asks.
The other four fields are accepted, kept and returned by
``get_option``, and change nothing: FORMAT, NTHREADS, ``backend`` and
``chunk`` are not consulted, since each operation takes its orientation
from its descriptor and its engine and block sizes from its operands.
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = ["Options", "global_options", "init", "set_option", "get_option",
           "BLOCKING", "NONBLOCKING", "BY_ROW", "BY_COL", "is_cache_key",
           "public_options"]

BLOCKING = "blocking"
NONBLOCKING = "nonblocking"
BY_ROW = "by_row"
BY_COL = "by_col"


@dataclasses.dataclass
class Options:
    mode: str = NONBLOCKING          # GrB_Mode
    format: str = BY_ROW             # GxB_FORMAT
    hyper_ratio: float = 1.0 / 16    # GxB_HYPER: hyper_conform threshold
    nthreads: int = 0                # 0 = auto block size
    backend: str = "auto"            # 'bitmap' | 'csr' | 'bsr' | 'auto'
    chunk: int = 1 << 14             # edge-chunk for gather kernels


_state = threading.local()


def global_options() -> Options:
    opts = getattr(_state, "opts", None)
    if opts is None:
        opts = Options()
        _state.opts = opts
    return opts


def init(mode: str = NONBLOCKING) -> None:
    """``GrB_init`` analogue: reset the global options and set the mode
    (the device is torch's to set up; this configures the framework)."""
    _state.opts = Options(mode=mode)


def set_option(name: str, value) -> None:
    opts = global_options()
    if not hasattr(opts, name):
        raise KeyError(f"unknown option {name!r}")
    setattr(opts, name, value)


def get_option(name: str):
    return getattr(global_options(), name)


# A sparse container's ``_options`` holds two kinds of keys.  The
# engines' caches are tied to the container's tensors: the host pattern
# (``host_pattern``), the bitdot plan (``bitdot_plan``), and plans under
# names that start with "_" or under tuple keys.  Every other key is a
# per-object option (``GxB_Matrix_Option_set``: ``format``,
# ``hyper_ratio``, ``bsr_spmv``, or any name of the caller's).
_CACHE_NAMES = frozenset({"host_pattern", "bitdot_plan"})


def is_cache_key(key) -> bool:
    """Whether ``key`` of a container's ``_options`` names an engine
    cache (which a user option may not overwrite)."""
    return (not isinstance(key, str) or key.startswith("_")
            or key in _CACHE_NAMES)


def public_options(options: dict) -> dict:
    """The per-object options of ``options`` without the engine caches:
    what a container with a new pattern inherits from its source."""
    return {k: v for k, v in options.items() if not is_cache_key(k)}
