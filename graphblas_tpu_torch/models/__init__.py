"""models of the PyTorch port (counterparts of graphblas_tpu.models):
the counting models through the GraphBLAS operations (triangle counting,
k-truss), Kronecker generation, and the graph generators."""

from .generate import wathen_coo
from .kron import kron_generate, kron_submatrix, kron_tuples
from .ktruss import SUPPORT, allktruss, ktruss
from .rmat import rmat_edges, symmetrize_pattern
from .tricount import METHODS, edge_incidence, tricount, tricount_prep

__all__ = [
    "tricount", "tricount_prep", "edge_incidence", "METHODS", "ktruss",
    "allktruss", "SUPPORT", "kron_generate", "kron_submatrix",
    "kron_tuples", "wathen_coo", "rmat_edges", "symmetrize_pattern",
]
