"""PageRank demo (reference ``Demo/Program/pagerank_demo.c``): runs the
fp64, scaled-integer, and UDT-semiring variants and prints the top nodes
side by side.

Usage: python -m graphblas_tpu_torch.demos.pagerank [--device DEV]
       [graph.tsv] [topk]      (the graph is read from stdin if absent)
"""
from graphblas_tpu_torch import io as gio, models
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, args = demo_args(argv)
    topk = int(args[1]) if len(args) > 1 else 10
    src = args[0] if args else "/dev/stdin"
    A = gio.read_matrix(src, boolean=True, no_self_edges=True, device=dev)
    n = A.nrows
    print(f"n {n} edges {A.nvals()}")
    d = models.dpagerank(A)
    i = models.ipagerank(A)
    x, iters = models.dpagerank2(A, itermax=100, tol=1e-5)
    print(f"dpagerank2 iters: {iters}")
    print(f"Top {min(topk, n)} nodes:")
    for k in range(min(topk, n)):
        print(f"  {k}: d:[{d[k][0]:6d} : {d[k][1]:.8e}] "
              f"i:[{i[k][0]:6d} : {i[k][1]}] "
              f"x:[{x[k][0]:6d} : {x[k][1]:.8e}]")


if __name__ == "__main__":
    main()
