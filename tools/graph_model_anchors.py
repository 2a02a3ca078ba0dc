"""Exactness anchors of the graph models from the JAX package on the CPU.

Runs ``models.mis`` (seed 42) and ``models.bfs5m`` from vertex 0 on the
symmetrized R-MAT graph (edge factor 16, seed 7) as a BOOL ``CsrMatrix``,
and ``models.dpagerank`` / ``models.ipagerank`` (20 iterations) on it as
a bitmap ``Matrix``, and prints one JSON line per run with its wall
time: the MIS set's size and a digest of its members, the BFS level
counts, and the PageRank top-10 pages.  These are the anchors the
PyTorch port's ``chip_smoke.py`` holds its models to.

    JAX_PLATFORMS=cpu python tools/graph_model_anchors.py --mis 16 18 \\
        --bfs 18 --pagerank 12

The bitmap PageRank holds n x n FP64 values: keep its scale small on a
host with little memory (scale 12 is 134 MB, scale 14 2.1 GB).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import graphblas_tpu as gb  # noqa: E402
from graphblas_tpu import models  # noqa: E402
from graphblas_tpu.models.rmat import (rmat_edges,  # noqa: E402
                                       symmetrize_pattern)
from graphblas_tpu.sparse.container import CsrMatrix  # noqa: E402


def graph(scale: int):
    n = 1 << scale
    I, J = symmetrize_pattern(*rmat_edges(scale, 16, seed=7), n)
    return I, J, n


def digest(idx: np.ndarray) -> str:
    return hashlib.sha256(np.asarray(idx, np.int64).tobytes()).hexdigest()[:16]


def run_mis(scale: int) -> dict:
    I, J, n = graph(scale)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n, type=gb.BOOL,
                           sum_duplicates=False)
    t0 = time.perf_counter()
    iset = models.mis(A, seed=42)
    secs = time.perf_counter() - t0
    Is, Xs = iset.extractTuples()
    members = Is[np.asarray(Xs, bool)]
    return {"model": "mis", "scale": scale, "seed": 42,
            "iset": int(len(members)), "sha256_16": digest(members),
            "seconds": secs}


def run_bfs(scale: int) -> dict:
    I, J, n = graph(scale)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n, type=gb.BOOL,
                           sum_duplicates=False)
    t0 = time.perf_counter()
    v = models.bfs5m(A, 0)
    secs = time.perf_counter() - t0
    lev = np.where(v.pattern_np(), v.to_dense(), 0)
    vals, cnts = np.unique(lev, return_counts=True)
    return {"model": "bfs5m", "scale": scale, "source": 0,
            "levels": dict(zip(map(int, vals), map(int, cnts))),
            "seconds": secs}


def run_pagerank(scale: int) -> list:
    I, J, n = graph(scale)
    A = gb.Matrix.from_coo(I, J, np.ones(len(I), bool), n, n, type=gb.BOOL)
    out = []
    for name, fn in (("dpagerank", models.dpagerank),
                     ("ipagerank", models.ipagerank)):
        t0 = time.perf_counter()
        ranks = fn(A)
        secs = time.perf_counter() - t0
        out.append({"model": name, "scale": scale, "iters": 20,
                    "top10": [int(p) for p, _ in ranks[:10]],
                    "top10_values": [float(r) if name == "dpagerank"
                                     else int(r) for _, r in ranks[:10]],
                    "seconds": secs})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mis", type=int, nargs="*", default=[])
    ap.add_argument("--bfs", type=int, nargs="*", default=[])
    ap.add_argument("--pagerank", type=int, nargs="*", default=[])
    args = ap.parse_args()
    for s in args.pagerank:
        for rec in run_pagerank(s):
            print(json.dumps(rec), flush=True)
    for s in args.bfs:
        print(json.dumps(run_bfs(s)), flush=True)
    for s in args.mis:
        print(json.dumps(run_mis(s)), flush=True)


if __name__ == "__main__":
    main()
