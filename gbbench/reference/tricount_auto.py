"""Plain reference of the triangle count, in PyTorch on the benchmark's
own triplets.  It imports nothing of the port.

The graph is taken as undirected and simple (the diagonal dropped, each
pair once).  Vertices are ranked by (degree, id), each edge is oriented
from its lower to its higher rank, and a triangle {a < b < c} is found
once: at its lowest vertex a, as the wedge (a; b, c) of two out-edges
whose ends b < c are joined, looked up in the sorted edge keys.  Work in
blocks of wedges, on the triplets' device.
"""

from __future__ import annotations

import torch

#: the count is exact (limit 0)
LIMITS = {"count_gap": 0}

BLOCK = 1 << 26


def simple_edges(I: torch.Tensor, J: torch.Tensor, n: int):
    """(u, v) with u < v: each undirected pair of the triplets once, the
    diagonal dropped."""
    u, v = torch.minimum(I, J), torch.maximum(I, J)
    keep = u != v
    key = torch.unique(u[keep] * n + v[keep])
    return key // n, key % n


def oriented(u: torch.Tensor, v: torch.Tensor, n: int):
    """(src, dst, key, ptr): the edges from lower to higher (degree,
    id) rank, in rank ids, sorted by (src, dst); key = src * n + dst;
    ptr the CSR row pointers of src."""
    dev = u.device
    deg = torch.bincount(torch.cat([u, v]), minlength=n)
    order = torch.argsort(deg * n + torch.arange(n, device=dev))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    a, b = rank[u], rank[v]
    key = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    src, dst = key // n, key % n
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return src, dst, key, ptr


def wedge_hits(src, dst, key, ptr, n: int, block: int = BLOCK):
    """Yield, block by block, the closed-wedge flags of every wedge
    (a; b, c): for the out-edge (a, c) at position p of a's row, the
    wedges with b = the row's entries before it."""
    m = src.numel()
    dev = src.device
    pos = torch.arange(m, device=dev) - ptr[src]
    ends = torch.cumsum(pos, 0)
    e0 = 0
    while e0 < m:
        base = int(ends[e0 - 1]) if e0 else 0
        e1 = int(torch.searchsorted(ends, base + block, right=True))
        e1 = max(e1, e0 + 1)
        cnt = pos[e0:e1]
        lanes = int(ends[e1 - 1]) - base
        if lanes:
            eid = torch.repeat_interleave(
                torch.arange(e0, e1, device=dev), cnt, output_size=lanes)
            first = torch.cumsum(cnt, 0) - cnt
            t = torch.arange(lanes, device=dev) - first[eid - e0]
            b = dst[ptr[src[eid]] + t]
            q = b * n + dst[eid]
            at = torch.searchsorted(key, q).clamp(max=m - 1)
            yield key[at] == q
        e0 = e1


def count(inputs: dict) -> tuple:
    n = inputs["n"]
    u, v = simple_edges(inputs["I"], inputs["J"], n)
    src, dst, key, ptr = oriented(u, v, n)
    return src, dst, key, ptr, n, u.numel()


def expected(inputs: dict):
    """(triangles, sizes): the exact count, in int64."""
    src, dst, key, ptr, n, m = count(inputs)
    total = torch.zeros((), dtype=torch.int64, device=src.device)
    for hit in wedge_hits(src, dst, key, ptr, n):
        total += hit.sum(dtype=torch.int64)
    return int(total), {"n": n, "m": m}


def control(inputs: dict, dtype=torch.bfloat16) -> int:
    """The count with its running total in ``dtype``: each block's hits
    summed in float32, as tensor cores accumulate, and added to a total
    kept in ``dtype`` (bfloat16 by default; float32 is exact to 2^24)."""
    src, dst, key, ptr, n, _ = count(inputs)
    total = torch.zeros((), dtype=dtype, device=src.device)
    for hit in wedge_hits(src, dst, key, ptr, n):
        total += hit.sum(dtype=torch.float32).to(dtype)
    return int(total.double())


def control_numbers(inputs: dict) -> dict:
    """The check's numbers with the control in the program's place."""
    want, _ = expected(inputs)
    return {"count_gap": abs(control(inputs) - want),
            "count_gap_float32": abs(control(inputs, torch.float32)
                                     - want)}
