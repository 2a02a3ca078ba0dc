"""``mxm(C, M, None, "plus_times", L, U)`` in FP32: the masked valued
product C<M> = L·U, each call into a fresh empty FP32 CSR C.

The benchmark makes the operands itself, on the card and with no call
into the port: the graph's vertices ranked by ascending degree (ties by
label), L its strictly lower and U its strictly upper part in that
order, M on L's pattern, and values U[0.5, 1.5) in float32 drawn from
the seed for L, then U, then M.  Set-up hands the three to the port
(``CsrMatrix.from_coo``: the ``build`` span).  A sample of the window's
products, drawn from the seed, is compared with the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

import graphblas_tpu_torch as gt

from ..harness import generator

#: the products compared (each holds its C on the card until the check)
SAMPLE = 2


def degree_split(I: torch.Tensor, J: torch.Tensor, n: int):
    """((Lr, Lc), (Ur, Uc)): the entries below and above the diagonal
    once the vertices are ranked by ascending degree, ties by label."""
    deg = torch.bincount(I, minlength=n)
    order = torch.argsort(deg, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=I.device)
    a, b = rank[I], rank[J]
    lo, up = a > b, a < b
    return (a[lo], b[lo]), (a[up], b[up])


def make_inputs(graph: dict, cfg: dict, traffic: dict, seed: int,
                device) -> dict:
    n = graph["n"]
    (Lr, Lc), (Ur, Uc) = degree_split(graph["I"], graph["J"], n)
    g = generator(device, seed, 1)
    lo, hi = traffic["values"]

    def vals(k):
        return (torch.rand(k, generator=g, device=device) * (hi - lo)
                + lo).to(torch.float32)
    return {"n": n, "L": (Lr, Lc, vals(Lr.numel())),
            "U": (Ur, Uc, vals(Ur.numel())),
            "M": (Lr, Lc, vals(Lr.numel()))}


def setup(inputs: dict, cfg: dict, traffic: dict, spans, device) -> dict:
    n = inputs["n"]
    host = {k: [t.cpu().numpy() for t in inputs[k]] for k in "LUM"}
    with spans("build"):
        ops = {k: gt.CsrMatrix.from_coo(r, c, x, n, n, type=gt.FP32,
                                        sum_duplicates=False, device=device)
               for k, (r, c, x) in host.items()}
    ops["n"] = n
    ops["semiring"] = traffic["semiring"]
    return ops


def call(state: dict, i: int):
    n = state["n"]
    e = np.zeros(0, np.int64)
    C = gt.CsrMatrix.from_coo(e, e, np.zeros(0, np.float32), n, n,
                              type=gt.FP32, device=state["L"].device)
    return gt.mxm(C, state["M"], None, state["semiring"], state["L"],
                  state["U"])


def check(inputs: dict, kept: list, ref):
    """({pattern_gap, value_gap}, sizes) over the kept products: the
    entries in one pattern and not the other, and the largest gap of a
    value from the reference's over the sum of its terms' magnitudes."""
    want = ref.expected(inputs)
    pattern = value = None
    for _, C in kept:
        C = C.wait()
        p, v = ref.compare(C.rowids[:C.nvals], C.indices[:C.nvals],
                           C.values[:C.nvals], want, inputs["n"])
        pattern = p if pattern is None else max(pattern, p)
        value = v if value is None else max(value, v)
    info = {"n": inputs["n"], "nnz": {k: int(inputs[k][0].numel())
                                      for k in "LUM"},
            "nnz_C": int(want["key"].numel())}
    return {"pattern_gap": pattern, "value_gap": value}, info
