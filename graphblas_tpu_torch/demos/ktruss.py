"""k-truss demo (reference ``Extras/ktruss`` mains): GraphBLAS-style and
sparse fast-path k-truss + the all-k-truss sweep.

Usage: python -m graphblas_tpu_torch.demos.ktruss [--device DEV]
       [graph.tsv] [k]
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import io as gio, models, sparse as sp
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, args = demo_args(argv)
    k = int(args[1]) if len(args) > 1 else 3
    if args:
        A = gio.read_matrix(args[0], make_symmetric=True,
                            no_self_edges=True, boolean=True, device=dev)
    else:
        pat = models.wathen_pattern(4, 4)
        np.fill_diagonal(pat, False)
        A = gt.Matrix.from_dense(pat, gt.BOOL, pattern=pat, device=dev)
    C, nsteps = models.ktruss(A, k)
    ne = C.nvals() // 2
    print(f"{k}-truss: {ne} edges, {nsteps} steps (graphblas path)")
    (ei, ej, supp), nsteps2 = sp.ktruss_sparse(A, k)
    ne2 = int((supp >= k - 2).sum()) // 2
    print(f"{k}-truss: {ne2} edges, {nsteps2} steps (sparse path)")
    if ne != ne2:
        raise SystemExit(f"ktruss_demo: the paths disagree, {ne} != {ne2}")
    allk = models.allktruss(A)
    for kk in sorted(allk):
        st = allk[kk]
        print(f"k = {kk}: {st['nedges']} edges, {st['nsteps']} steps, "
              f"{st['nt']} triangles")


if __name__ == "__main__":
    main()
