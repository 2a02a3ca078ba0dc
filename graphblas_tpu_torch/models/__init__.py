"""models of the PyTorch port (counterparts of graphblas_tpu.models):
the graph algorithms through the GraphBLAS operations (BFS, MIS,
PageRank, triangle counting, k-truss), Kronecker generation, and the
graph generators."""

from .bfs import (bfs, bfs5m, bfs5m_check, bfs6, bfs6_check, bfs_jit,
                  bfs_level)
from .generate import random_matrix, wathen, wathen_coo, wathen_pattern
from .kron import kron_generate, kron_submatrix, kron_tuples
from .ktruss import SUPPORT, allktruss, ktruss
from .mis import mis, mis_check
from .pagerank import (PAGERANK_TYPE, dpagerank, dpagerank2,
                       dpagerank2_csr, drowscale, ipagerank, irowscale,
                       pagerank_jit, pagerank_ops)
from .rmat import rmat_edges, rmat_graph, symmetrize_pattern
from .tricount import METHODS, edge_incidence, tricount, tricount_prep

__all__ = [
    "bfs", "bfs5m", "bfs6", "bfs5m_check", "bfs6_check", "bfs_level",
    "bfs_jit", "dpagerank", "ipagerank", "dpagerank2", "dpagerank2_csr",
    "drowscale", "irowscale", "pagerank_jit", "PAGERANK_TYPE",
    "pagerank_ops", "mis", "mis_check",
    "tricount", "tricount_prep", "edge_incidence", "METHODS", "ktruss",
    "allktruss", "SUPPORT", "kron_generate", "kron_submatrix",
    "kron_tuples", "wathen", "wathen_coo", "wathen_pattern",
    "random_matrix", "rmat_edges", "rmat_graph", "symmetrize_pattern",
]
