"""GraphBLAS builtin type table for the PyTorch port.

Counterpart of ``graphblas_tpu/core/types.py``: the 11 builtin types of
the reference (``Source/GB_ops.c:21-48``).  A type names its GraphBLAS
semantics by a numpy ``dtype`` (what host code and the JAX package
compare against) and its device storage by a ``torch`` dtype.

Unsigned types keep signed torch storage of the same width: on torch,
uint16/32/64 lack ``+``, ``maximum``, ``//``, ``scatter_reduce`` and
matmul, so UINT16/32/64 values live in int16/32/64 tensors holding the
same bits.  Code that compares, divides or takes min/max of UINT values
must apply unsigned semantics itself.  UINT8 follows the same rule for
uniformity.  User-defined and complex types come with a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Type", "BOOL", "INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32",
    "INT64", "UINT64", "FP32", "FP64", "BUILTIN_TYPES", "type_of_dtype",
    "type_by_name",
]


@dataclasses.dataclass(frozen=True)
class Type:
    """A builtin GraphBLAS scalar type: semantics (``dtype``) and device
    storage (``storage``)."""

    name: str
    dtype: np.dtype
    storage: torch.dtype

    @property
    def is_unsigned(self) -> bool:
        return np.issubdtype(self.dtype, np.unsignedinteger)

    def to_storage(self, x: np.ndarray) -> np.ndarray:
        """Host values of this type as an array torch can hold: unsigned
        values are reinterpreted bit for bit as the signed type."""
        x = np.asarray(x).astype(self.dtype, copy=False)
        if self.is_unsigned:
            x = x.view(x.dtype.str.replace("u", "i"))
        return x

    def __repr__(self) -> str:  # pragma: no cover
        return f"Type({self.name})"


BOOL = Type("BOOL", np.dtype(np.bool_), torch.bool)
INT8 = Type("INT8", np.dtype(np.int8), torch.int8)
UINT8 = Type("UINT8", np.dtype(np.uint8), torch.int8)
INT16 = Type("INT16", np.dtype(np.int16), torch.int16)
UINT16 = Type("UINT16", np.dtype(np.uint16), torch.int16)
INT32 = Type("INT32", np.dtype(np.int32), torch.int32)
UINT32 = Type("UINT32", np.dtype(np.uint32), torch.int32)
INT64 = Type("INT64", np.dtype(np.int64), torch.int64)
UINT64 = Type("UINT64", np.dtype(np.uint64), torch.int64)
FP32 = Type("FP32", np.dtype(np.float32), torch.float32)
FP64 = Type("FP64", np.dtype(np.float64), torch.float64)

BUILTIN_TYPES = (BOOL, INT8, UINT8, INT16, UINT16, INT32, UINT32, INT64,
                 UINT64, FP32, FP64)

_BY_DTYPE = {t.dtype: t for t in BUILTIN_TYPES}
_BY_NAME = {t.name: t for t in BUILTIN_TYPES}


def type_of_dtype(dtype) -> Type:
    """Look up the GraphBLAS Type for a numpy dtype."""
    d = np.dtype(dtype)
    if d not in _BY_DTYPE:
        raise TypeError(f"no GraphBLAS type for dtype {d}")
    return _BY_DTYPE[d]


def type_by_name(name: str) -> Type:
    """Look up a builtin Type by its GraphBLAS name ("BOOL", "FP32", ...)."""
    if name not in _BY_NAME:
        raise TypeError(f"no builtin GraphBLAS type named {name!r}")
    return _BY_NAME[name]
