"""GraphBLAS error model.

The reference returns ``GrB_Info`` codes with a thread-local error string
(``Source/GB_error.c``, ``GrB_error``).  Pythonically, errors are
exceptions carrying the equivalent info code; ``GrB_SUCCESS`` /
``GrB_NO_VALUE`` map to normal returns.
"""

from __future__ import annotations

import enum
import threading

__all__ = ["Info", "GraphBLASError", "DimensionMismatch", "DomainMismatch",
           "IndexOutOfBounds", "InvalidValue", "EmptyObject", "OutOfMemory",
           "last_error_message"]

# thread-local last-error slot, the analogue of the reference's TLS
# error string (GB_error.c / GB_thread_local_access, GB_init.c:250-296):
# every GraphBLASError records its message here at construction so the
# C-style facade's GrB_error() can report it after catching.
_tls = threading.local()


def last_error_message() -> str:
    return getattr(_tls, "msg", "")


class Info(enum.IntEnum):
    # mirror of GrB_Info (Include/GraphBLAS.h:285-310)
    SUCCESS = 0
    NO_VALUE = 1
    UNINITIALIZED_OBJECT = 2
    INVALID_OBJECT = 3
    NULL_POINTER = 4
    INVALID_VALUE = 5
    INVALID_INDEX = 6
    DOMAIN_MISMATCH = 7
    DIMENSION_MISMATCH = 8
    OUTPUT_NOT_EMPTY = 9
    OUT_OF_MEMORY = 10
    INSUFFICIENT_SPACE = 11
    INDEX_OUT_OF_BOUNDS = 12
    PANIC = 13


class GraphBLASError(Exception):
    info = Info.PANIC

    def __init__(self, *args):
        super().__init__(*args)
        _tls.msg = (f"GraphBLAS error: {self.info.name}: "
                    f"{args[0] if args else ''}")


class DimensionMismatch(GraphBLASError):
    info = Info.DIMENSION_MISMATCH


class DomainMismatch(GraphBLASError):
    info = Info.DOMAIN_MISMATCH


class IndexOutOfBounds(GraphBLASError):
    info = Info.INDEX_OUT_OF_BOUNDS


class InvalidValue(GraphBLASError):
    info = Info.INVALID_VALUE


class EmptyObject(GraphBLASError):
    info = Info.UNINITIALIZED_OBJECT


class OutOfMemory(GraphBLASError):
    """``GrB_OUT_OF_MEMORY`` — raised by real allocation failure or by
    the fault-injection countdown (``utils/faultinject.py``)."""
    info = Info.OUT_OF_MEMORY
