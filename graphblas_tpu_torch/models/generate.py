"""Matrix generators: Wathen FEM matrices and random graphs.

Counterpart of ``graphblas_tpu/models/generate.py``.  Reference
behavior: ``Demo/Source/wathen.c`` (four equivalent build methods for
the MATLAB gallery('wathen') matrix; random RHO drawn from the portable
simple_rand stream) and ``Demo/Source/random_matrix.c``.  The triplet
assembly is vectorized numpy (``wathen_coo``); the reference's method
distinctions (build vs setElement vs submatrix-accumulate) collapse
into one batched build, but the ``method`` argument is kept.  The
matrices are bitmap ``Matrix`` containers on ``device`` (the card by
default, see :func:`graphblas_tpu_torch.sparse.container.resolve_device`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.matrix import Matrix
from ..core.ops import binary
from ..core.types import BOOL, FP64
from ..utils.simple_rand import SimpleRand

__all__ = ["wathen", "wathen_coo", "wathen_pattern", "random_matrix"]

# the 8x8 element matrix of gallery('wathen')  (wathen.c:69-77), times 1/45
_E = np.asarray([
    [6, -6, 2, -8, 3, -8, 2, -6],
    [-6, 32, -6, 20, -8, 16, -8, 20],
    [2, -6, 6, -6, 2, -8, 3, -8],
    [-8, 20, -6, 32, -6, 20, -8, 16],
    [3, -8, 2, -6, 6, -6, 2, -8],
    [-8, 16, -8, 20, -6, 32, -6, 20],
    [2, -8, 3, -8, 2, -6, 6, -6],
    [-6, 20, -8, 16, -8, 20, -6, 32],
], dtype=np.float64) / 45.0


def wathen_coo(nx: int, ny: int, rho: Optional[np.ndarray] = None,
               seed: int = 1):
    """Host-side Wathen triplets: (I, J, X, n).  Pure numpy — used by
    benchmarks and distributed loaders that assemble shards directly
    without materializing a device-resident dense matrix."""
    n = 3 * nx * ny + 2 * nx + 2 * ny + 1
    if rho is None:
        rng = SimpleRand(seed)
        # reference order: for j in 1..ny: for i in 1..nx  (wathen.c:98-110)
        rho = (100.0 * rng.rand_x_batch(nx * ny)).reshape(ny, nx).T
    else:
        rho = np.asarray(rho, dtype=np.float64).reshape(nx, ny)

    # vectorized node numbering for every (i,j) element (wathen.c:163-170)
    i = np.arange(1, nx + 1)[None, :]           # [1, nx]
    j = np.arange(1, ny + 1)[:, None]           # [ny, 1]
    nn = np.empty((ny, nx, 8), dtype=np.int64)
    nn[..., 0] = 3 * j * nx + 2 * i + 2 * j + 1
    nn[..., 1] = nn[..., 0] - 1
    nn[..., 2] = nn[..., 1] - 1
    nn[..., 3] = (3 * j - 1) * nx + 2 * j + i - 1
    nn[..., 4] = 3 * (j - 1) * nx + 2 * i + 2 * j - 3
    nn[..., 5] = nn[..., 4] + 1
    nn[..., 6] = nn[..., 5] + 1
    nn[..., 7] = nn[..., 3] + 1
    nn -= 1

    # all 64 (krow, kcol) pairs per element, scaled by rho(i,j)
    I = np.broadcast_to(nn[..., :, None], (ny, nx, 8, 8)).reshape(-1)
    J = np.broadcast_to(nn[..., None, :], (ny, nx, 8, 8)).reshape(-1)
    X = (rho.T[..., None, None] * _E[None, None]).reshape(-1)
    return I, J, X, n


def wathen(nx: int, ny: int, method: int = 0,
           rho: Optional[np.ndarray] = None, seed: int = 1,
           device=None) -> Matrix:
    """n x n Wathen FEM matrix, n = 3*nx*ny + 2*nx + 2*ny + 1.

    ``rho`` is the nx-by-ny density matrix; when None it is drawn as
    100*simple_rand_x() in the reference's exact stream order (column-major
    over (i,j)) so demo matrices reproduce bit-for-bit.
    """
    if nx < 0 or ny < 0 or not (0 <= method <= 3):
        raise ValueError("invalid wathen arguments")
    I, J, X, n = wathen_coo(nx, ny, rho=rho, seed=seed)
    return Matrix.from_coo(I, J, X, n, n, type=FP64, dup=binary.plus[FP64],
                           device=device)


def wathen_pattern(nx: int, ny: int, seed: int = 1) -> np.ndarray:
    """Host-only boolean adjacency of the Wathen matrix (no device)."""
    I, J, X, n = wathen_coo(nx, ny, seed=seed)
    pat = np.zeros((n, n), dtype=bool)
    pat[I, J] = True
    return pat


def random_matrix(nrows: int, ncols: int, ntuples: int,
                  make_symmetric: bool = False, no_self_edges: bool = False,
                  boolean: bool = False, method: int = 0,
                  seed: int = 1, device=None) -> Matrix:
    """Random matrix with ~ntuples entries, bit-matching the reference's
    ``random_matrix.c:148-173``: per draw i = rand_i % nrows,
    j = rand_i % ncols; a skipped self edge consumes NO value draw; the
    symmetric twin (j,i) reuses x; duplicates assembled with SECOND
    (last write wins, ``GrB_SECOND_FP64``)."""
    rng = SimpleRand(seed)
    I, J, X = [], [], []
    for _ in range(ntuples):
        i = int(rng.rand_i() % np.uint64(nrows))
        j = int(rng.rand_i() % np.uint64(ncols))
        if no_self_edges and i == j:
            continue
        x = rng.rand_x()
        I.append(i)
        J.append(j)
        X.append(x)
        if make_symmetric:
            I.append(j)
            J.append(i)
            X.append(x)
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    X = np.asarray(X, np.float64)
    if boolean:
        return Matrix.from_coo(I, J, X != 0, nrows, ncols, type=BOOL,
                               dup=binary.second[BOOL], device=device)
    return Matrix.from_coo(I, J, X, nrows, ncols, type=FP64,
                           dup=binary.second[FP64], device=device)
