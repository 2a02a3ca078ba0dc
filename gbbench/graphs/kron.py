"""The Graph500 Kronecker generator (GAP's ``kron`` graph), on the card.

Each of ``edge_factor * 2**scale`` edges picks one quadrant per bit
level with probabilities (a, b, c, 1-a-b-c), as the Graph500 reference
``kronecker_generator`` does; the graph's structure is drawn from the
configuration's fixed ``generator_seed`` (GAP also generates from a fixed
seed), and the run's seed scrambles the vertex labels (Graph500's random
relabelling).  The graph is then made undirected, with self-loops and
duplicates removed: every entry is stored in both directions, sorted by
(row, column).  ``labels`` maps each vertex of the structure to its
label.
"""

from __future__ import annotations

import torch

from ..harness import generator


def make(cfg: dict, seed: int, device) -> dict:
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n = 1 << scale
    m = ef * n
    g = torch.Generator(device=device)
    g.manual_seed(int(cfg["generator_seed"]))
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    I = torch.zeros(m, dtype=torch.int64, device=device)
    J = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        r = torch.rand((2, m), generator=g, device=device)
        ib = r[0] > ab
        jb = r[1] > torch.where(ib, c_norm, a_norm)
        I |= ib.to(torch.int64) << level
        J |= jb.to(torch.int64) << level
    del r, ib, jb
    perm = torch.randperm(n, generator=generator(device, seed, 0),
                          device=device)
    I, J = perm[I], perm[J]
    keep = I != J
    I, J = I[keep], J[keep]
    lin = torch.unique(torch.cat([I * n + J, J * n + I]))
    return {"n": n, "I": lin // n, "J": lin % n, "X": None,
            "duplicates": False, "labels": perm}
