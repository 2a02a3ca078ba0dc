"""Scale run: triangle counting, BFS and PageRank on R-MAT graphs.

Counterpart of ``tools/scale_run.py``: the same functions and the same
JSON keys a line, plus ``"device"``.  The graph is the symmetrized
R-MAT of edge factor 16 and seed 7; triangle counting is the
degree-ordered prep (the reference's ``tri_prep``) and ``tricount_esc``
twice (cold, then warm, equal); BFS is a ``csr_mxv(lor_land[BOOL])``
frontier loop with one host read a level; PageRank is 20 steps of
``r = A (0.85 r / deg) + 0.15 / n`` by ``csr_mxv(plus_times[FP32])``
over a ones-valued copy of A (not ``pagerank_csr``).  Every timed
window ends in a device synchronize; ``peak_dev_bytes`` is
``torch.cuda.max_memory_allocated()`` since a reset at the start of
each algorithm (null on the CPU).

    python -m graphblas_tpu_torch.tools.scale_run [scales...]
        [--algs tricount,bfs,pagerank] [--device cpu]

Default scales: 18 20.  Runs on the card unless given ``--device cpu``;
without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.semirings import semiring
from ..core.types import BOOL, FP32
from ..models.rmat import rmat_edges, symmetrize_pattern
from ..sparse.container import CsrMatrix, resolve_device
from ..sparse.spmv import csr_mxv
from ..sparse.tri import tricount_esc, tricount_prep_csr

__all__ = ["ALGS", "build", "run_tricount", "run_bfs", "run_pagerank",
           "main"]

ALGS = ("tricount", "bfs", "pagerank")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def devmem(device: torch.device):
    """Peak bytes allocated on the card since the last reset; None on
    the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def emit(rec: dict, device: torch.device) -> dict:
    rec["device"] = str(device)
    print(json.dumps(rec), flush=True)
    return rec


def build(scale: int, device=None):
    """(A, n, nnz): the symmetrized, deduplicated R-MAT graph without
    self loops as a BOOL CSR on ``device``."""
    n = 1 << scale
    I, J = rmat_edges(scale, 16, seed=7)
    I, J = symmetrize_pattern(I, J, n)
    A = CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n, type=BOOL,
                           sum_duplicates=False, device=device)
    return A, n, len(I)


def run_tricount(A: CsrMatrix, n: int, nnz: int, scale: int):
    """(record, (L, U)): the prep's factors come back for reuse."""
    dev = A.device
    reset_peak(dev)
    t0 = time.perf_counter()
    L, U = tricount_prep_csr(A)
    sync(dev)
    prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntri = tricount_esc(L, U)           # plans built inside the call
    sync(dev)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    ntri2 = tricount_esc(L, U)
    sync(dev)
    dt = time.perf_counter() - t0       # warm: plans cached
    assert ntri == ntri2, (ntri, ntri2)
    return emit({
        "alg": "tricount", "scale": scale, "n": n, "nnz": nnz,
        "ntri": ntri, "prep_s": prep, "cold_s": cold, "time_s": dt,
        "nnz_per_s": nnz / dt, "edges_per_s": (nnz // 2) / dt,
        "peak_dev_bytes": devmem(dev),
    }, dev), (L, U)


def run_bfs(A: CsrMatrix, n: int, nnz: int, scale: int, src: int = 0):
    """(record, visited): ``visited`` is the bool vector of reached
    vertices on A's device.  A is symmetric, so ``A x`` expands the
    frontier."""
    dev = A.device
    sr = semiring.lor_land[BOOL]
    reset_peak(dev)
    qw = torch.zeros(n, dtype=torch.bool, device=dev)
    qw[src] = True
    yw, _ = csr_mxv(sr, A, qw)          # warm
    int(yw.bool().sum())
    v = qw.clone()
    q = qw
    sync(dev)
    t0 = time.perf_counter()
    levels = 0
    nvisited = 1
    while True:
        y, _ = csr_mxv(sr, A, q)
        q = y.bool() & ~v
        newc = int(q.sum())             # one host read a level
        if newc == 0:
            break
        v |= q
        levels += 1
        nvisited += newc
    sync(dev)
    dt = time.perf_counter() - t0
    return emit({
        "alg": "bfs", "scale": scale, "n": n, "nnz": nnz,
        "levels": levels, "visited": nvisited, "time_s": dt,
        "traversed_edges_per_s": nnz * levels / dt,
        "peak_dev_bytes": devmem(dev),
    }, dev), v


def run_pagerank(A: CsrMatrix, n: int, nnz: int, scale: int,
                 iters: int = 20):
    """(record, r): ``r`` is the float32 rank vector after ``iters``
    steps of ``r = A (0.85 r / max(deg, 1)) + 0.15 / n`` (A symmetric,
    so A' = A; the degree scaling goes on x before the SpMV)."""
    dev = A.device
    sr = semiring.plus_times[FP32]
    reset_peak(dev)
    deg = A.row_degrees().to(torch.float32)
    invd = 1.0 / torch.clamp(deg, min=1.0)
    Af = CsrMatrix(A.indptr, A.indices, A.rowids,
                   torch.ones(A.nzmax, dtype=torch.float32, device=dev),
                   A.nvals, n, n, FP32)
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    a = 0.15 / n
    yw, _ = csr_mxv(sr, Af, 0.85 * r * invd)   # warm
    float(yw.sum())
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        y, _ = csr_mxv(sr, Af, 0.85 * r * invd)
        r = y + a
    s = float(r.sum())
    sync(dev)
    dt = time.perf_counter() - t0
    return emit({
        "alg": "pagerank", "scale": scale, "n": n, "nnz": nnz,
        "iters": iters, "time_s": dt, "time_per_iter_s": dt / iters,
        "nnz_per_s_per_iter": nnz * iters / dt, "rank_sum": s,
        "peak_dev_bytes": devmem(dev),
    }, dev), r


def main(argv=None) -> list:
    """Run the algorithms at each scale; returns the records."""
    p = argparse.ArgumentParser(prog="scale_run", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("scales", nargs="*", type=int, default=[18, 20])
    p.add_argument("--algs", default=",".join(ALGS),
                   help="comma-separated subset of " + ",".join(ALGS))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    algs = args.algs.split(",")
    unknown = set(algs) - set(ALGS)
    if unknown:
        p.error(f"unknown algorithms {sorted(unknown)}")
    recs = []
    for scale in args.scales:
        t0 = time.perf_counter()
        A, n, nnz = build(scale, dev)
        sync(dev)
        recs.append(emit({"alg": "build", "scale": scale, "n": n,
                          "nnz": nnz, "time_s": time.perf_counter() - t0},
                         A.device))
        if "tricount" in algs:
            recs.append(run_tricount(A, n, nnz, scale)[0])
        if "bfs" in algs:
            recs.append(run_bfs(A, n, nnz, scale)[0])
        if "pagerank" in algs:
            recs.append(run_pagerank(A, n, nnz, scale)[0])
        del A
    return recs


if __name__ == "__main__":
    main()
