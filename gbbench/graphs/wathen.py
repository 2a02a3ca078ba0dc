"""The Wathen finite-element matrix (MATLAB ``gallery('wathen', nx,
ny)``, SuiteSparse:GraphBLAS ``Demo/Source/wathen.c``), on the card.

An nx-by-ny grid of 8-node serendipity elements; element (i, j) adds
rho(i, j) times the fixed 8x8 element matrix to the rows and columns of
its nodes.  The pattern depends on nx and ny alone; the run's seed
draws the densities rho as 100 * U[0, 1), as ``wathen.c`` does, and a
triangle count does not read them.  Returned as the element triplets,
duplicates not yet summed (the assembly is the container build's).
"""

from __future__ import annotations

import torch

from ..harness import generator

#: the element matrix times 45 (gallery('wathen'): [e1 e2; e2' e1])
ELEMENT = (
    (6, -6, 2, -8, 3, -8, 2, -6),
    (-6, 32, -6, 20, -8, 16, -8, 20),
    (2, -6, 6, -6, 2, -8, 3, -8),
    (-8, 20, -6, 32, -6, 20, -8, 16),
    (3, -8, 2, -6, 6, -6, 2, -8),
    (-8, 16, -8, 20, -6, 32, -6, 20),
    (2, -8, 3, -8, 2, -6, 6, -6),
    (-6, 20, -8, 16, -8, 20, -6, 32),
)


def nodes(nx: int, ny: int, device) -> torch.Tensor:
    """(ny, nx, 8) zero-based node numbers of every element, in the
    numbering of gallery('wathen')."""
    i = torch.arange(1, nx + 1, device=device).view(1, nx)
    j = torch.arange(1, ny + 1, device=device).view(ny, 1)
    n1 = 3 * j * nx + 2 * i + 2 * j + 1
    n4 = (3 * j - 1) * nx + 2 * j + i - 1
    n5 = 3 * (j - 1) * nx + 2 * i + 2 * j - 3
    nn = torch.stack([n1, n1 - 1, n1 - 2, n4, n5, n5 + 1, n5 + 2, n4 + 1],
                     dim=-1)
    return nn - 1


def make(cfg: dict, seed: int, device) -> dict:
    nx, ny = int(cfg["nx"]), int(cfg["ny"])
    n = 3 * nx * ny + 2 * nx + 2 * ny + 1
    nn = nodes(nx, ny, device)
    rho = 100.0 * torch.rand((ny, nx), generator=generator(device, seed, 0),
                             dtype=torch.float64, device=device)
    E = torch.tensor(ELEMENT, dtype=torch.float64, device=device) / 45.0
    I = nn.unsqueeze(-1).expand(ny, nx, 8, 8).reshape(-1)
    J = nn.unsqueeze(-2).expand(ny, nx, 8, 8).reshape(-1)
    X = (rho.view(ny, nx, 1, 1) * E).reshape(-1)
    return {"n": n, "I": I, "J": J, "X": X, "duplicates": True}
