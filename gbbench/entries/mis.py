"""``models.mis(A, seed=s)``: Luby's maximal independent set written
with the GraphBLAS API as the reference's ``Demo/Source/mis.c`` writes
it (per pass the scores by a masked apply, ``vxm`` over a MAX-FIRST FP64
semiring, ``eWiseAdd``, masked applies and a ``vxm`` over LOR_LAND),
each call with the next of the traffic's ``seeds`` (64) stream seeds,
which the run's seed draws in [1, 2^31) on a stream of their own.  As
users run MIS on one graph again and again with fresh seeds, the graph
stays.  Set-up is the ``bfs_csr`` entry's (``CsrMatrix.from_coo``: the
``build`` span).  A call returns the set as a ``Vector``; a
sample of the window's sets is compared with the reference's, outside
the timed calls.
"""

from __future__ import annotations

import numpy as np
import torch

import graphblas_tpu_torch as gt

from ..harness import sub_seed

#: the sets compared (each a Vector on the card until the check)
SAMPLE = 8


def make_inputs(graph: dict, cfg: dict, traffic: dict, seed: int,
                device) -> dict:
    rng = np.random.default_rng(sub_seed(seed, 4))
    seeds = rng.integers(1, 1 << 31, size=int(traffic["seeds"]))
    return dict(graph, seeds=seeds.tolist())


def setup(inputs: dict, cfg: dict, traffic: dict, spans, device) -> dict:
    n = inputs["n"]
    I = inputs["I"].cpu().numpy()
    J = inputs["J"].cpu().numpy()
    with spans("build"):
        A = gt.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                                  type=gt.BOOL,
                                  sum_duplicates=inputs["duplicates"],
                                  device=device)
    return {"A": A, "seeds": inputs["seeds"]}


def call(state: dict, i: int):
    seeds = state["seeds"]
    return gt.models.mis(state["A"], seed=seeds[i % len(seeds)])


def members(v) -> torch.Tensor:
    """The set of an iset ``Vector`` as a bool tensor of n."""
    v = v.wait()
    return v.pattern & v.values.to(torch.bool)


def check(inputs: dict, kept: list, ref):
    """({set_gap, independence_gap, maximal_gap}, sizes): the most in
    any kept call (``ref.numbers``)."""
    seeds = inputs["seeds"]
    calls = [(seeds[i % len(seeds)], members(v)) for i, v in kept]
    numbers = ref.numbers(inputs, calls) if calls else dict.fromkeys(
        ref.LIMITS)
    info = {"n": inputs["n"], "nnz": int(inputs["I"].numel())}
    return numbers, info
