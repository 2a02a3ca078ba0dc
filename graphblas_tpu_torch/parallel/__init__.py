"""Distribution over rank meshes: sharded containers, collective-backed
GraphBLAS operations and scaled graph algorithms, on
``torch.distributed`` (counterpart of ``graphblas_tpu/parallel``).

Every rank is a process and calls each operation with the same
arguments; :func:`run_world` starts a world of ranks on this host.
``P`` is a plain placement spec (an axis name or None per dimension)
and ``NamedSharding`` a (mesh, spec) pair."""

from .mesh import (make_mesh, row_sharding, replicated, P, Mesh,
                   NamedSharding)
from .launch import run_world
from .dist import (DistMatrix, DistVector, distribute, collect, dist_vxm,
                   dist_mxm, dist_mxm_bshard, dist_mxm_summa)
from .algorithms import (dist_bfs, dist_pagerank, dist_tricount,
                         bfs_step_sharded, pagerank_step_sharded)
from .dist_csr import (DistCsr, dist_csr_from_matrix, dist_csr_mxv,
                       dist_csr_pagerank, dist_csr_bfs)
from .dist_spgemm import (dist_masked_spgemm, dist_spgemm,
                          dist_tricount_csr)

__all__ = [
    "make_mesh", "row_sharding", "replicated", "P", "Mesh",
    "NamedSharding", "run_world",
    "DistMatrix", "DistVector", "distribute", "collect", "dist_vxm",
    "dist_mxm", "dist_mxm_bshard", "dist_mxm_summa", "dist_bfs",
    "dist_pagerank", "dist_tricount", "bfs_step_sharded",
    "pagerank_step_sharded",
    "DistCsr", "dist_csr_from_matrix", "dist_csr_mxv",
    "dist_csr_pagerank", "dist_csr_bfs",
    "dist_masked_spgemm", "dist_spgemm", "dist_tricount_csr",
]
