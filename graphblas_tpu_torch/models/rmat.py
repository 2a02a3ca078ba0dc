"""R-MAT / Kronecker power-law graph generator (Graph500-style).

Counterpart of ``graphblas_tpu/models/rmat.py`` (pure numpy; the
``rmat_graph`` container constructor comes with a later slice).

The reference generates Kronecker graphs by explicit tuple expansion
(``Extras/ExactKronGen``); the R-MAT recursive form generates the same
family directly at scale: each edge picks one quadrant per bit level
with probabilities (a, b, c, d).  Fully vectorized host generation —
2^20-edge batches draw in milliseconds — feeding the sharded-CSR
containers without any dense intermediate.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["rmat_edges", "symmetrize_pattern"]


def rmat_edges(scale: int, edge_factor: int = 16,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               seed: int = 1,
               dedup: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(I, J) of an undirected R-MAT graph: 2^scale nodes,
    ~edge_factor * 2^scale edges (Graph500 parameters by default)."""
    n = 1 << scale
    ne = edge_factor * n
    rng = np.random.default_rng(seed)
    I = np.zeros(ne, np.int64)
    J = np.zeros(ne, np.int64)
    ab = a + b
    c_norm = c / (1 - ab)
    a_norm = a / ab
    for depth in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        i_bit = r1 > ab
        j_bit = np.where(i_bit, r2 > c_norm, r2 > a_norm)
        I |= (i_bit.astype(np.int64) << depth)
        J |= (j_bit.astype(np.int64) << depth)
    # symmetrize + drop self edges
    keep = I != J
    I, J = I[keep], J[keep]
    I2 = np.concatenate([I, J])
    J2 = np.concatenate([J, I])
    if dedup:
        lin = I2 * n + J2
        lin = np.unique(lin)
        I2, J2 = lin // n, lin % n
    return I2, J2


def symmetrize_pattern(I: np.ndarray, J: np.ndarray, n: int):
    """Sorted unique {(i,j)} U {(j,i)} minus the diagonal — the
    standard undirected-graph prep of every runner."""
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    return lin // n, lin % n
