"""``bfs_csr(A, s)``: the BFS levels from a source, repeated over the
traffic's ``sources`` (64) in turn.  As GAP's BFS does, the sources are
non-isolated vertices drawn from a fixed seed (the configuration's
``generator_seed``): every run searches from the same vertices of the
graph's structure, under the labels its seed drew and in an order its
seed draws, so that every seed does the same work.  Set-up hands the
benchmark's graph to the port (``CsrMatrix.from_coo``: the ``build``
span).  A sample of the window's level vectors, drawn from the seed, is
compared with the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

import graphblas_tpu_torch as gt

from ..harness import generator

#: the level vectors compared (host arrays of n int32 each)
SAMPLE = 16


def make_inputs(graph: dict, cfg: dict, traffic: dict, seed: int,
                device) -> dict:
    n = graph["n"]
    k = int(traffic["sources"])
    deg = torch.bincount(graph["I"], minlength=n)
    labels = graph.get("labels")
    if labels is None:
        labels = torch.arange(n, device=device)
    fixed = generator(device, int(cfg["generator_seed"]), 3)
    cand = labels[torch.randperm(n, generator=fixed, device=device)]
    cand = cand[deg[cand] > 0][:k]
    order = torch.randperm(cand.numel(), generator=generator(device, seed, 2),
                           device=device)
    return dict(graph, sources=cand[order].tolist())


def setup(inputs: dict, cfg: dict, traffic: dict, spans, device) -> dict:
    n = inputs["n"]
    I = inputs["I"].cpu().numpy()
    J = inputs["J"].cpu().numpy()
    with spans("build"):
        A = gt.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                                  type=gt.BOOL,
                                  sum_duplicates=inputs["duplicates"],
                                  device=device)
    return {"A": A, "sources": inputs["sources"]}


def call(state: dict, i: int):
    src = state["sources"]
    return gt.bfs_csr(state["A"], src[i % len(src)])


def check(inputs: dict, kept: list, ref):
    """({level_gap}, sizes): the vertices whose level differs from the
    reference's, the most in any kept call."""
    src = inputs["sources"]
    cache = {}
    gap = None
    for i, lev in kept:
        s = src[i % len(src)]
        if s not in cache:
            cache[s] = ref.levels(inputs, s).cpu().numpy()
        g = int(np.count_nonzero(np.asarray(lev) != cache[s]))
        gap = g if gap is None else max(gap, g)
    info = {"n": inputs["n"], "nnz": int(inputs["I"].numel())}
    return {"level_gap": gap}, info
