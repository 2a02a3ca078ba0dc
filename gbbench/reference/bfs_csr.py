"""Plain reference of BFS levels (1 = the source, 0 = unreached) along
the benchmark's own entries, from row to column, in PyTorch.  It imports
nothing of the port.  A frontier gathers its vertices' adjacency lists
from a CSR the reference sorts itself; the unreached ends form the next
frontier.  ``control`` counts each vertex's frontier neighbours in int8
instead of gathering them, the precision below the port's int32 count,
and takes a vertex as reached where its count is positive."""

from __future__ import annotations

import torch

#: every level is exact
LIMITS = {"level_gap": 0}


def _csr(inputs: dict):
    n = inputs["n"]
    I, J = inputs["I"], inputs["J"]
    key, o = torch.sort(I * n + J)
    dst = J[o]
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=I.device)
    ptr[1:] = torch.cumsum(torch.bincount(I, minlength=n), 0)
    return ptr, dst


def levels(inputs: dict, s: int, count_dtype=None) -> torch.Tensor:
    n = inputs["n"]
    ptr, dst = _csr(inputs)
    dev = dst.device
    lev = torch.zeros(n, dtype=torch.int32, device=dev)
    lev[s] = 1
    frontier = torch.tensor([s], dtype=torch.int64, device=dev)
    level = 1
    while frontier.numel():
        level += 1
        deg = ptr[frontier + 1] - ptr[frontier]
        total = int(deg.sum())
        if total == 0:
            break
        fid = torch.repeat_interleave(torch.arange(frontier.numel(),
                                                   device=dev), deg,
                                      output_size=total)
        first = torch.cumsum(deg, 0) - deg
        nb = dst[ptr[frontier][fid] + torch.arange(total, device=dev)
                 - first[fid]]
        if count_dtype is None:
            new = torch.unique(nb[lev[nb] == 0])
        else:
            hits = torch.zeros(n, dtype=count_dtype, device=dev)
            hits.index_add_(0, nb, torch.ones_like(nb, dtype=count_dtype))
            new = torch.nonzero((hits > 0) & (lev == 0)).flatten()
        lev[new] = level
        frontier = new
    return lev


def control(inputs: dict, s: int) -> torch.Tensor:
    return levels(inputs, s, count_dtype=torch.int8)


def control_numbers(inputs: dict) -> dict:
    """The check's numbers with the control in the program's place,
    over every source of the traffic."""
    gap = 0
    for s in inputs["sources"]:
        gap = max(gap, int((control(inputs, s) != levels(inputs, s)).sum()))
    return {"level_gap": gap}
