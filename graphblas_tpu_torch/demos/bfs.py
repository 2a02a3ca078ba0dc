"""BFS demo (reference ``Demo/Program/bfs_demo.c``): read a triplet graph
(or generate Wathen), run all BFS variants, report levels + reachability.

Usage: python -m graphblas_tpu_torch.demos.bfs [--device DEV] [graph.tsv]
       [source]
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import io as gio, models
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, args = demo_args(argv)
    src = int(args[1]) if len(args) > 1 else 0
    if args:
        A = gio.read_matrix(args[0], make_symmetric=True,
                            no_self_edges=True, boolean=True, device=dev)
    else:
        W = models.wathen(4, 4, device=dev)
        pat = W.pattern_np()
        np.fill_diagonal(pat, False)
        A = gt.Matrix.from_dense(pat, gt.BOOL, pattern=pat, device=dev)
    n = A.nrows
    print(f"number of nodes: {n}")
    for name, fn in (("bfs5m", models.bfs5m), ("bfs6", models.bfs6)):
        v = fn(A, src)
        lev = np.where(v.pattern_np(), v.to_dense(), 0)
        nreach = int((lev != 0).sum())
        print(f"nodes reachable from node {src}: {nreach} out of {n} "
              f"({name})")
        print(f"max level: {int(lev.max())}")
    lev = models.bfs_jit(A, src)
    print(f"nodes reachable from node {src}: "
          f"{int((lev != 0).sum())} out of {n} (bfs_jit)")


if __name__ == "__main__":
    main()
