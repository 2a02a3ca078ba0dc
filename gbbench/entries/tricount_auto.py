"""``tricount_auto(L, U)``: the SandiaDot triangle count, repeated.

The traffic's ``operands`` say how L and U reach the port.  With
``prep``, set-up hands the benchmark's triplets to the port
(``CsrMatrix.from_coo``: the ``build`` span) and the port splits the
graph (the ``prep`` span): by ascending degree with
``tricount_prep_csr`` where the configuration's ``tc_order`` is
``degree`` (GAP's TC), in the natural order with ``csr_tril`` /
``csr_triu`` where it is ``natural`` (``tri_demo``).  With ``lu``, the
caller splits the pattern itself, in the same order, and hands L and U
to the port as triplets (the ``build`` span: two ``from_coo``), as a
caller holding both triangles does.  Every call's count is compared
with the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

import graphblas_tpu_torch as gt

#: every call's result is checked
SAMPLE = None


def make_inputs(graph: dict, cfg: dict, traffic: dict, seed: int,
                device) -> dict:
    return graph


def setup(inputs: dict, cfg: dict, traffic: dict, spans, device) -> dict:
    if traffic["operands"] == "lu":
        return _setup_lu(inputs, cfg, spans, device)
    n = inputs["n"]
    I = inputs["I"].cpu().numpy()
    J = inputs["J"].cpu().numpy()
    if inputs["X"] is None:
        X, t = np.ones(len(I), bool), gt.BOOL
    else:
        X, t = inputs["X"].cpu().numpy(), gt.FP64
    with spans("build"):
        A = gt.CsrMatrix.from_coo(I, J, X, n, n, type=t,
                                  sum_duplicates=inputs["duplicates"],
                                  device=device)
    del I, J, X
    with spans("prep"):
        if cfg["tc_order"] == "degree":
            L, U = gt.tricount_prep_csr(A)
        else:
            L, U = gt.csr_tril(A), gt.csr_triu(A)
    return {"L": L, "U": U}


def _setup_lu(inputs: dict, cfg: dict, spans, device) -> dict:
    from .mxm import degree_split
    n = inputs["n"]
    key = torch.unique(inputs["I"] * n + inputs["J"])
    I, J = key // n, key % n
    if cfg["tc_order"] == "degree":
        L, U = degree_split(I, J, n)
    else:
        L, U = (I[I > J], J[I > J]), (I[I < J], J[I < J])
    host = [[t.cpu().numpy() for t in X] for X in (L, U)]
    with spans("build"):
        L, U = (gt.CsrMatrix.from_coo(r, c, np.ones(len(r), bool), n, n,
                                      type=gt.BOOL, sum_duplicates=False,
                                      device=device) for r, c in host)
    return {"L": L, "U": U}


def call(state: dict, i: int) -> int:
    return gt.tricount_auto(state["L"], state["U"])


def check(inputs: dict, kept: list, ref):
    """({count_gap}, sizes): the largest gap between a call's count and
    the reference's."""
    want, info = ref.expected(inputs)
    gap = max(abs(int(out) - want) for _, out in kept) if kept else None
    info["ntri"] = want
    return {"count_gap": gap}, info
