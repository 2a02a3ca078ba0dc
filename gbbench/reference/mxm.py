"""Plain reference of the masked product C<M> = A·B over plus_times, in
PyTorch on the benchmark's own operands (COO triplets).  It imports
nothing of the port.

Every term A(i,k)·B(k,j) is formed (an expansion of each A entry by
B's row k, in blocks of terms), kept where M(i,j) is present and
nonzero, and summed into its mask entry in float64; C's pattern is the
mask entries that received a term.  ``control`` computes the same in
TF32, the nearest precision below float32: each operand rounded to
TF32's 10-bit mantissa, products and sums in float32.
"""

from __future__ import annotations

import torch

#: C's pattern is exact; a value may be off by rounding in float32 (see
#: PERF.md for the readings the limit was set from)
LIMITS = {"pattern_gap": 0, "value_gap": 1e-4}

BLOCK = 1 << 26


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def product(A, B, M, n: int, dtype=torch.float64, round_tf32=False):
    """{key, value, magnitude}: C's entries sorted by key = i * n + j,
    their values and the sums of their terms' magnitudes."""
    Ar, Ac, Av = A
    Br, Bc, Bv = B
    Mr, Mc, Mv = M
    dev = Ar.device
    ob = torch.argsort(Br * n + Bc)
    Bc, Bv = Bc[ob], Bv[ob]
    bptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    bptr[1:] = torch.cumsum(torch.bincount(Br, minlength=n), 0)
    mkey, om = torch.sort(Mr * n + Mc)
    mtrue = Mv[om] != 0
    nm = mkey.numel()
    acc = torch.zeros(nm, dtype=dtype, device=dev)
    mag = torch.zeros(nm, dtype=dtype, device=dev)
    hits = torch.zeros(nm, dtype=torch.int32, device=dev)
    if round_tf32:
        Av, Bv = tf32(Av), tf32(Bv)
    deg = (bptr[Ac + 1] - bptr[Ac])
    ends = torch.cumsum(deg, 0)
    na = Ar.numel()
    e0 = 0
    while e0 < na and nm:
        base = int(ends[e0 - 1]) if e0 else 0
        e1 = max(int(torch.searchsorted(ends, base + BLOCK, right=True)),
                 e0 + 1)
        cnt = deg[e0:e1]
        lanes = int(ends[e1 - 1]) - base
        if lanes:
            eid = torch.repeat_interleave(
                torch.arange(e0, e1, device=dev), cnt, output_size=lanes)
            first = torch.cumsum(cnt, 0) - cnt
            at = bptr[Ac[eid]] + torch.arange(lanes, device=dev) \
                - first[eid - e0]
            q = Ar[eid] * n + Bc[at]
            p = torch.searchsorted(mkey, q).clamp(max=nm - 1)
            ok = (mkey[p] == q) & mtrue[p]
            p = p[ok]
            term = Av[eid[ok]].to(dtype) * Bv[at[ok]].to(dtype)
            acc.index_add_(0, p, term)
            mag.index_add_(0, p, term.abs())
            hits.index_add_(0, p, torch.ones_like(p, dtype=torch.int32))
        e0 = e1
    present = hits > 0
    return {"key": mkey[present], "value": acc[present],
            "magnitude": mag[present]}


def expected(inputs: dict) -> dict:
    return product(inputs["L"], inputs["U"], inputs["M"], inputs["n"])


def control(inputs: dict) -> dict:
    return product(inputs["L"], inputs["U"], inputs["M"], inputs["n"],
                   dtype=torch.float32, round_tf32=True)


def compare(rows, cols, values, want: dict, n: int):
    """(pattern_gap, value_gap) of a product given as COO against
    ``want``: the keys in one and not the other, and the largest
    |value - want| / magnitude over the keys in both."""
    key = rows.to(torch.int64) * n + cols.to(torch.int64)
    key, o = torch.sort(key)
    values = values[o].to(torch.float64)
    wk = want["key"]
    if wk.numel() == 0 or key.numel() == 0:
        return int(wk.numel() + key.numel()), 0.0
    at = torch.searchsorted(wk, key).clamp(max=wk.numel() - 1)
    both = wk[at] == key
    common = int(both.sum())
    pattern = key.numel() + wk.numel() - 2 * common
    if common == 0:
        return int(pattern), float("inf")
    a = at[both]
    gap = ((values[both] - want["value"][a].to(torch.float64)).abs()
           / want["magnitude"][a].to(torch.float64))
    return int(pattern), float(gap.max())


def control_numbers(inputs: dict) -> dict:
    """The check's numbers with the control in the program's place."""
    want = expected(inputs)
    got = control(inputs)
    n = inputs["n"]
    p, v = compare(got["key"] // n, got["key"] % n, got["value"], want, n)
    return {"pattern_gap": p, "value_gap": v}
