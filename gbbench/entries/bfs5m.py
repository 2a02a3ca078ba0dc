"""``models.bfs5m(A, s)``: the reference's own BFS written with the
GraphBLAS API (``Demo/Source/bfs5m.c``: per level a masked assign of
the level, a ``vxm`` over LOR_LAND under the complemented visited mask,
a reduce to the successor flag), repeated over the traffic's
``sources`` (64) in turn.  Inputs, set-up (``CsrMatrix.from_coo``: the
``build`` span) and the sources are the ``bfs_csr`` entry's, so both
entries search the same graph from the same vertices.  A call returns
the level ``Vector``; the check turns each sampled one into int32
levels (0 = unreached) and compares them with the reference's, outside
the timed calls.
"""

from __future__ import annotations

import numpy as np
import torch

import graphblas_tpu_torch as gt

from . import bfs_csr

#: the level vectors compared (each a Vector on the card until the check)
SAMPLE = bfs_csr.SAMPLE

make_inputs = bfs_csr.make_inputs
setup = bfs_csr.setup


def call(state: dict, i: int):
    src = state["sources"]
    return gt.models.bfs5m(state["A"], src[i % len(src)])


def levels(v) -> np.ndarray:
    """A level ``Vector`` as host int32 levels, 0 where it has no
    entry."""
    v = v.wait()
    zero = torch.zeros((), dtype=v.values.dtype, device=v.values.device)
    return torch.where(v.pattern, v.values, zero).to(torch.int32).cpu(
        ).numpy()


def check(inputs: dict, kept: list, ref):
    """({level_gap}, sizes), as the ``bfs_csr`` entry's."""
    return bfs_csr.check(inputs, [(i, levels(v)) for i, v in kept], ref)
