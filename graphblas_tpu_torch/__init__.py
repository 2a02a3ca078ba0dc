"""graphblas_tpu_torch: the PyTorch / CUDA port of graphblas_tpu.

The JAX package ``graphblas_tpu`` is the reference; this package keeps
its module paths and function names so each counterpart is easy to find,
and imports no JAX.  This first slice carries masked structural SpGEMM
triangle counting on CSR containers (SandiaDot ``ntri = sum (L·U') .* L``)
with three hand-written CUDA kernels for Hopper: the band-ring and
window-count panel kernels (:mod:`sparse.cuda_window`) and the bitmap
popcount pass (:mod:`sparse.bitdot`).  The kernels are built with
``nvcc`` on first use, never at import.

Tensors default to CUDA when a card is present, else the CPU; every
constructor takes an explicit ``device``.  On CPU tensors each kernel
wrapper runs the kernel's plain PyTorch version.
"""

from . import convert
from .core.errors import (DimensionMismatch, DomainMismatch,
                          GraphBLASError, IndexOutOfBounds, Info,
                          InvalidValue)
from .core.types import (BOOL, FP32, FP64, INT8, INT16, INT32, INT64,
                         UINT8, UINT16, UINT32, UINT64, Type,
                         type_of_dtype)
from .models.generate import wathen_coo
from .models.rmat import rmat_edges, symmetrize_pattern
from .ops.flopcount import jax_engine_name, last_axb_method
from .sparse import *  # noqa: F401,F403
from .sparse import __all__ as _sparse_all

__all__ = [
    "convert", "DimensionMismatch", "DomainMismatch", "GraphBLASError",
    "IndexOutOfBounds", "Info", "InvalidValue",
    "BOOL", "FP32", "FP64", "INT8", "INT16", "INT32", "INT64", "UINT8",
    "UINT16", "UINT32", "UINT64", "Type", "type_of_dtype",
    "wathen_coo", "rmat_edges", "symmetrize_pattern",
    "jax_engine_name", "last_axb_method", *_sparse_all,
]
