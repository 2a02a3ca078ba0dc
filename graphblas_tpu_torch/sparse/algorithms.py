"""Whole-loop graph algorithms on the padded-CSR container.

Counterpart of ``graphblas_tpu/sparse/algorithms.py``: BFS levels and
PageRank as edge-parallel loops on the container's COO dual (``rowids``,
``indices``), O(nnz) work per iteration, on the container's device.
Frontier expansion is one gather and one scatter-add count; PageRank's
SpMV is one gather, a multiply and one scatter-add.  Both use the
containers' sentinel padding (padded lanes land in a dropped slot), so
the loops need no masking.  The JAX package compiles each loop into one
program (``lax.while_loop``/``fori_loop``); here each iteration is a few
eager torch ops, and BFS reads back one flag per level to stop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import counters
from ..utils.counters import host_read
from .container import CsrMatrix

__all__ = ["bfs_csr", "pagerank_csr"]


@counters.spanned("gb.entry.bfs_csr")
def bfs_csr(A: CsrMatrix, s: int) -> np.ndarray:
    """BFS levels from vertex ``s`` (1 = source, 0 = unreachable): the
    frontier q expands along the entries, from their rows to their
    columns.  The level loop is the span ``gb.engines.bfs_loop``; it
    reads back one flag a level (``gb.read.bfs_frontier``), then the
    levels once."""
    n = A.nrows
    dev = A.device
    rows = A.rowids.clamp(max=n).long()      # sentinel -> dropped slot
    cols = A.indices.clamp(max=n).long()
    lev = torch.zeros(n, dtype=torch.int32, device=dev)
    q = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    q[s] = True
    level = 1
    with counters.span("gb.engines.bfs_loop"):
        while level <= n and host_read(q.any(), "bfs_frontier", bool):
            lev = torch.where(q[:n], level, lev)
            hit = torch.zeros(n + 1, dtype=torch.int32, device=dev)
            hit.index_add_(0, cols, q[rows].to(torch.int32))
            q[:n] = (hit[:n] > 0) & (lev == 0)
            level += 1
    return host_read(lev, "bfs_levels", np.ndarray)


def pagerank_csr(A: CsrMatrix, iters: int = 20) -> np.ndarray:
    """PageRank ranks (normalized), damped power iteration in float32:
    each step sends r[i] / outdeg(i) along every entry (i, j);
    dangling vertices' mass drops, and every vertex gets the teleport
    share 0.15/n of the total."""
    n = A.nrows
    dev = A.device
    # 1/outdeg(i) from the row pointers, on the device; 0 for rows with
    # no entries and for the sentinel slot of the padded lanes
    deg = (A.indptr[1:] - A.indptr[:-1]).to(torch.float32)
    inv = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    inv[:n] = torch.where(deg > 0, 1.0 / deg, 0.0)
    rows = A.rowids.clamp(max=n).long()
    cols = A.indices.clamp(max=n).long()
    damp = torch.tensor(0.85, dtype=torch.float32, device=dev)
    tele = torch.tensor(np.float32(0.15 / n), device=dev)
    r = torch.full((n + 1,), 1.0 / n, dtype=torch.float32, device=dev)
    r[n] = 0.0
    for _ in range(iters):
        nxt = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        nxt.index_add_(0, cols, (r * inv)[rows])
        total = r[:n].sum()
        r = damp * nxt + tele * total
        r[n] = 0.0
    r = r[:n].cpu().numpy()
    return r / r.sum()
