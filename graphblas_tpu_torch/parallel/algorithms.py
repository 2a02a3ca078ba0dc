"""Distributed graph algorithms over a rank mesh: bitmap blocks.

Counterpart of ``graphblas_tpu/parallel/algorithms.py``: the models'
math with the adjacency matrix row-block-sharded over "i" and one
collective a level or an iteration.  The JAX package runs each loop as
one compiled SPMD program; here a loop runs on every rank in Python,
its state replicated, its test (``q.any()``) read on every rank alike.
The step functions are plain functions of tensors on the rank's shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.matrix import Matrix
from ..core.types import FP32, FP64
from ..ops.mxm import _dot, _int_mm, _pattern_mm
from . import comm, introspect
from .dist import distribute
from .mesh import Mesh, make_mesh

__all__ = ["dist_bfs", "dist_pagerank", "dist_tricount",
           "bfs_step_sharded", "pagerank_step_sharded"]


def _bfs_level(mesh: Mesh, v, q, Ap, level):
    """One level: frontier q (replicated) times this rank's row block of
    the pattern, joined over "i" (any), masked by the unvisited."""
    blk = Ap.shape[0]
    row0 = mesh.coord("i") * blk
    v = torch.where(q, level, v)
    part = _pattern_mm(q[row0:row0 + blk][None, :], Ap)[0]
    nxt = comm.pmax(part, mesh, "i")
    return v, nxt & (v == 0)


def dist_bfs(A, s: int, mesh: Optional[Mesh] = None) -> np.ndarray:
    """BFS levels (int32, 0 = unreached) with A row-sharded, one
    collective a level.  Takes a Matrix (sharded here) or a
    DistMatrix."""
    if isinstance(A, Matrix):
        A = distribute(A, mesh or make_mesh(), square=True)
    mesh = A.mesh
    n = A.pattern.shape[1]
    with introspect.record("dist_bfs", A.pattern):
        q = torch.zeros(n, dtype=torch.bool, device=mesh.device)
        q[s] = True
        v = torch.zeros(n, dtype=torch.int32, device=mesh.device)
        level = 1
        while level <= n and bool(q.any()):
            v, q = _bfs_level(mesh, v, q, A.pattern, level)
            level += 1
    return v.cpu().numpy()[:A.nrows]


def bfs_step_sharded(mesh: Mesh):
    """``step(v, q, Ap, level) -> (v', q')``: one BFS level, ``v`` and
    ``q`` replicated, ``Ap`` this rank's row block of the pattern."""
    def step(v, q, Ap, level):
        return _bfs_level(mesh, v, q, Ap, level)
    return step


def _pagerank_iter(mesh: Mesh, Cv, r, a, valid=None):
    blk = Cv.shape[0]
    row0 = mesh.coord("i") * blk
    s = a * r.sum()
    part = _dot((0.85 * r)[row0:row0 + blk][None, :], Cv,
                FP64 if Cv.dtype == torch.float64 else FP32)[0]
    r = comm.psum(part, mesh, "i") + s
    if valid is not None:
        # padded lanes would count phantom teleport mass in sum(r)
        r = torch.where(valid, r, 0.0)
    return r


def dist_pagerank(A, iters: int = 20,
                  mesh: Optional[Mesh] = None) -> np.ndarray:
    """Damped PageRank (as ``models.pagerank_jit``) with the row-scaled
    matrix row-sharded, one sum over "i" an iteration."""
    from ..models.pagerank import drowscale
    if isinstance(A, Matrix):
        D = distribute(drowscale(A), mesh or make_mesh(), square=True)
    else:
        D = A
    mesh = D.mesh
    n_pad = D.pattern.shape[1]
    n = D.nrows
    dt = D.values.dtype
    with introspect.record("dist_pagerank", D.values):
        idx = torch.arange(n_pad, device=mesh.device)
        valid = idx < n
        r = torch.where(valid, torch.full((n_pad,), 1.0 / n, dtype=dt,
                                          device=mesh.device), 0.0)
        a = torch.tensor((1 - 0.85) / n, dtype=dt, device=mesh.device)
        for _ in range(iters):
            r = _pagerank_iter(mesh, D.values, r, a, valid)
    r = r.cpu().numpy()[:n]
    return r / r.sum()


def pagerank_step_sharded(mesh: Mesh):
    """``step(Cv, r, a) -> r'``: one PageRank iteration, ``Cv`` this
    rank's row block of the row-scaled matrix, ``r`` replicated."""
    def step(Cv, r, a):
        return _pagerank_iter(mesh, Cv, r, a)
    return step


def dist_tricount(A, mesh: Optional[Mesh] = None) -> int:
    """SandiaDot triangle count sum((L·U') .* L) with L row-sharded, U
    on every rank, the mask applied to each rank's block product; each
    block is counted exactly in int64 and the counts summed over "i"."""
    from ..models.tricount import tricount_prep
    if not isinstance(A, Matrix):
        raise TypeError("dist_tricount expects a Matrix")
    mesh = mesh or make_mesh()
    L, U = tricount_prep(A)
    Ld = distribute(L, mesh, square=True)
    Up = U.wait().pattern.to(mesh.device)
    Up = torch.nn.functional.pad(Up, (0, Ld.pattern.shape[1] - U.ncols,
                                      0, Ld.pattern.shape[1] - U.nrows))
    with introspect.record("dist_tricount", Ld.pattern, Up):
        prod = _int_mm(Ld.pattern, Up.T)
        cnt = prod[Ld.pattern].sum().reshape(1)
        total = comm.psum(cnt, mesh, "i")
    return int(total.item())
