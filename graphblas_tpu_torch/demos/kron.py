"""Kronecker product demo (reference ``Demo/Program/kron_demo.c`` and the
``Extras/ExactKronGen`` MPI program): C = kron(A, B) computed in
communication-free shards, written as a triplet file.

Usage: python -m graphblas_tpu_torch.demos.kron [--device DEV] A.tsv B.tsv
       C.tsv [nshards]
"""
import sys
import time

import torch

from graphblas_tpu_torch import io as gio, models
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, args = demo_args(argv)
    if len(args) < 3:
        print("usage: python -m graphblas_tpu_torch.demos.kron "
              "[--device DEV] A.tsv B.tsv C.tsv [nshards]")
        sys.exit(1)
    nshards = int(args[3]) if len(args) > 3 else 1
    A = gio.read_matrix(args[0], device=dev)
    B = gio.read_matrix(args[1], device=dev)
    t0 = time.perf_counter()
    C = models.kron_generate(A, B, nshards=nshards)
    nvals = C.nvals()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"C = kron(A,B): {C.nrows} x {C.ncols}, {nvals} entries, "
          f"{dt:.3f} s ({nvals/max(dt, 1e-12)/1e6:.2f} M entries/s, "
          f"{nshards} shards)")
    gio.write_triplets(args[2], C)


if __name__ == "__main__":
    main()
