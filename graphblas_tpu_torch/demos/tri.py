"""Triangle-count demo (reference ``Demo/Program/tri_demo.c``): all six
methods plus the sparse/BSR fast paths, with edges/s rates.

Usage: python -m graphblas_tpu_torch.demos.tri [--device DEV] [graph.tsv]
"""
import time

import numpy as np
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import io as gio, models, sparse as sp
from graphblas_tpu_torch.demos._common import demo_args
from graphblas_tpu_torch.sparse.bsr import tricount_bsr


def _elapsed(t0: float) -> float:
    # the count is read back to the host, so the card's work is done;
    # the synchronize also covers any launch still queued
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None):
    dev, args = demo_args(argv)
    if args:
        A = gio.read_matrix(args[0], make_symmetric=True,
                            no_self_edges=True, boolean=True, device=dev)
        pat = A.pattern_np()
    else:
        pat = models.wathen_pattern(4, 4)
        np.fill_diagonal(pat, False)
        A = gt.Matrix.from_dense(pat, gt.BOOL, pattern=pat, device=dev)
    n = pat.shape[0]
    ne = int(pat.sum()) // 2
    print(f"nodes: {n} edges: {ne}")
    L, U = models.tricount_prep(A)
    E = models.edge_incidence(A)
    for m, name in enumerate(models.METHODS):
        t0 = time.perf_counter()
        ntri = models.tricount(m, A=A, E=E, L=L, U=U)
        dt = _elapsed(t0)
        print(f"triangles: {ntri}  method {name}: {dt:.6f} s "
              f"rate {ne/dt/1e6:.2f} M edges/s")
    t0 = time.perf_counter()
    ntri = sp.tricount_sparse(A)
    dt = _elapsed(t0)
    print(f"triangles: {ntri}  method bitpack: {dt:.6f} s")
    t0 = time.perf_counter()
    ntri = tricount_bsr(np.tril(pat, -1), np.triu(pat, 1), device=A.device)
    dt = _elapsed(t0)
    print(f"triangles: {ntri}  method bsr: {dt:.6f} s")


if __name__ == "__main__":
    main()
