"""Maximal-independent-set demo (reference ``Demo/Program/mis_demo.c``).

Usage: python -m graphblas_tpu_torch.demos.mis [--device DEV] [graph.tsv]
"""
import sys

import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import io as gio, models
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, args = demo_args(argv)
    if args:
        A = gio.read_matrix(args[0], make_symmetric=True,
                            no_self_edges=True, boolean=True, device=dev)
    else:
        pat = models.wathen_pattern(4, 4)
        np.fill_diagonal(pat, False)
        A = gt.Matrix.from_dense(pat, gt.BOOL, pattern=pat, device=dev)
    iset = models.mis(A, seed=1)
    isize = iset.nvals()
    print(f"isize: {isize}")
    print(f"independent set found: {isize} of {A.nrows} nodes")
    if models.mis_check(A, iset):
        print("maximal independent set status verified")
    else:
        print("ERROR: not a maximal independent set")
        sys.exit(1)


if __name__ == "__main__":
    main()
