"""I/O of the PyTorch port (counterparts of graphblas_tpu.io): triplet
files (the demo interchange format), MatrixMarket, ``.npz``
checkpoints, and the native C parser bridge."""

from .checkpoint import load_matrix, load_vector, save_matrix, save_vector
from .native import native_lib
from .read import (get_matrix, mmread, read_matrix, read_triplets,
                   write_triplets)

__all__ = ["read_triplets", "read_matrix", "write_triplets", "mmread",
           "get_matrix", "native_lib", "save_matrix", "load_matrix",
           "save_vector", "load_vector"]
