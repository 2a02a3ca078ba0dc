"""Plain reference of the ``mis`` entry: Luby's maximal independent set
as SuiteSparse:GraphBLAS ``Demo/Source/mis.c`` orders it, in PyTorch on
the benchmark's own triplets, with its own ``simple_rand`` stream in
numpy.  It imports nothing of the port.

The stream (``simple_rand.c``: state' = state * 1103515245 + 12345 mod
2^64, a draw the state's bits 16..30; ``simple_rand_x``: five draws
chained as i = i * 32767 + draw in uint64, over 2^64 - 1 in float64)
is vectorised by jump-ahead: the state m steps on is a_m * s + b_m,
with (a_m, b_m) the binary powers of the one-step map over the bits of
m (``stream_maps``), made once for a pass's 5k steps.

A pass, as ``mis.c`` orders it: one draw for every vertex with a
neighbour (the entries of ``degrees``, in index order), candidate or
not; a candidate's score 0.0001 + x / (1 + 2 * degree); the largest
score among its candidate neighbours; a candidate joins where it has
none or its score is strictly larger; members leave the candidates,
then their neighbours do.  Vertices with no neighbour are members from
the start.  Scores and their comparison are in float64, the program's
type; ``control_numbers`` computes them in bfloat16 (the draw, the
division and the sum, and the neighbour maximum compared in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

#: the set is exact: every vertex as the reference's, for the call's
#: stream seed; no stored edge inside it; no vertex with a neighbour
#: left outside it without a member neighbour
LIMITS = {"set_gap": 0, "independence_gap": 0, "maximal_gap": 0}

#: the calls the control compares: the traffic's first stream seeds, as
#: many as the check samples
CONTROL_CALLS = 8

_MUL, _ADD = 1103515245, 12345
_WRAP = (1 << 64) - 1


def stream_maps(count: int):
    """(a, b), uint64 arrays of ``count``: m steps of the generator take
    the state s to a[m-1] * s + b[m-1] (mod 2^64; numpy's uint64 array
    products wrap)."""
    m = np.arange(1, count + 1, dtype=np.uint64)
    a = np.ones(count, np.uint64)
    b = np.zeros(count, np.uint64)
    pa, pb = _MUL, _ADD              # the map of 2^j steps
    for j in range(int(count).bit_length()):
        bit = ((m >> np.uint64(j)) & np.uint64(1)).astype(bool)
        a = np.where(bit, a * np.uint64(pa), a)
        b = np.where(bit, b * np.uint64(pa) + np.uint64(pb), b)
        pa, pb = pa * pa & _WRAP, (pa * pb + pb) & _WRAP
    return a, b


class Stream:
    """The ``simple_rand_x`` stream of one seed, drawn a pass at a
    time."""

    def __init__(self, seed: int):
        self.state = int(seed) & _WRAP

    def draws(self, k: int, maps) -> np.ndarray:
        a, b = maps
        s = a[:5 * k] * np.uint64(self.state) + b[:5 * k]
        self.state = int(s[-1])
        d = ((s >> np.uint64(16)) & np.uint64(0x7FFF)).reshape(k, 5)
        i = np.zeros(k, np.uint64)
        for j in range(5):
            i = i * np.uint64(32767) + d[:, j]
        return i.astype(np.float64) / float(_WRAP)


def luby(inputs: dict, seed: int, dtype=torch.float64, maps=None):
    """(member, passes): the set as a bool tensor on the triplets'
    device and the passes it took; scores in ``dtype``.  ``maps``: the
    stream's maps for the graph, made here where not given."""
    n, I, J = inputs["n"], inputs["I"], inputs["J"]
    dev = I.device
    deg = torch.bincount(I, minlength=n)
    has = deg > 0
    k = int(has.sum())
    if maps is None:
        maps = stream_maps(5 * k)
    rank = (torch.cumsum(has, 0) - 1).clamp(min=0)
    weight = (1.0 + 2.0 * deg.to(torch.float64)).to(dtype)
    small = torch.tensor(0.0001, dtype=torch.float64).to(dtype)
    cand = has.clone()
    member = ~has
    stream = Stream(seed)
    passes = 0
    while bool(cand.any()):
        passes += 1
        x = torch.from_numpy(stream.draws(k, maps)).to(dev)[rank]
        score = small + x.to(dtype) / weight
        # exact in float64: the maximum and the comparison are dtype's
        prob = torch.where(cand, score, 0).to(torch.float64)
        live = cand[I]
        src, dst = I[live], J[live]
        nbmax = torch.zeros(n, dtype=torch.float64, device=dev)
        nbmax.scatter_reduce_(0, dst, prob[src], reduce="amax")
        has_nb = torch.zeros(n, dtype=torch.bool, device=dev)
        has_nb[dst] = True
        new = cand & (~has_nb | (prob > nbmax))
        member |= new
        cand &= ~new
        if not bool(cand.any()):
            break
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        hit[J[new[I]]] = True
        cand &= ~hit
    return member, passes


def independence_gap(inputs: dict, member: torch.Tensor) -> int:
    """Stored edges with both ends in the set."""
    I, J = inputs["I"], inputs["J"]
    return int((member[I] & member[J]).sum())


def maximal_gap(inputs: dict, member: torch.Tensor) -> int:
    """Vertices with a neighbour, outside the set, with no member
    neighbour."""
    n, I, J = inputs["n"], inputs["I"], inputs["J"]
    has = torch.bincount(I, minlength=n) > 0
    covered = torch.zeros(n, dtype=torch.bool, device=I.device)
    covered[J[member[I]]] = True
    return int((has & ~member & ~covered).sum())


def numbers(inputs: dict, calls, maps=None) -> dict:
    """The check's numbers over ``calls``, (stream seed, the set as a
    bool tensor) pairs: the most in any call."""
    out = dict.fromkeys(LIMITS, 0)
    cache = {}
    for seed, member in calls:
        if seed not in cache:
            cache[seed] = luby(inputs, seed, maps=maps)[0]
        member = member.to(cache[seed].device)
        got = {"set_gap": int((member != cache[seed]).sum()),
               "independence_gap": independence_gap(inputs, member),
               "maximal_gap": maximal_gap(inputs, member)}
        out = {k: max(out[k], got[k]) for k in out}
    return out


def control_numbers(inputs: dict, dtype=torch.bfloat16) -> dict:
    """The check's numbers with the control in the program's place:
    the scores computed in ``dtype``, over the traffic's first
    ``CONTROL_CALLS`` stream seeds."""
    n, I = inputs["n"], inputs["I"]
    k = int((torch.bincount(I, minlength=n) > 0).sum())
    maps = stream_maps(5 * k)
    seeds = inputs["seeds"][:CONTROL_CALLS]
    return numbers(inputs, [(s, luby(inputs, s, dtype, maps)[0])
                            for s in seeds], maps)
