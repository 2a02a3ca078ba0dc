"""Wathen FEM matrix triplets (pure numpy).

Counterpart of ``graphblas_tpu/models/generate.py::wathen_coo``, copied
without the JAX package's ``Matrix`` constructors.  Reference behavior:
``Demo/Source/wathen.c`` (the MATLAB gallery('wathen') matrix; random RHO
drawn from the portable simple_rand stream).  The dense ``wathen`` and
``random_matrix`` constructors come with the bitmap-matrix slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.simple_rand import SimpleRand

__all__ = ["wathen_coo"]

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
