"""Smoke-test demo (reference ``Demo/Program/simple_demo.c``): exercise
the basic API end to end with tiny objects.

Usage: python -m graphblas_tpu_torch.demos.simple [--device DEV]
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, _ = demo_args(argv)
    A = gt.Matrix.from_coo([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0], 3, 3,
                           device=dev)
    gt.fprint(A, "A", gt.SHORT)
    x = gt.Vector.from_dense(np.ones(3), device=dev)
    y = gt.mxv(gt.Vector.new(gt.FP64, 3, device=dev), None, None,
               gt.semiring.plus_times[gt.FP64], A, x)
    gt.fprint(y, "y = A*x", gt.SHORT)
    s = gt.reduce_to_scalar(None, gt.monoid.plus[gt.FP64], y)
    print(f"sum(y) = {s}")
    if s != 6.0:
        raise SystemExit(f"simple_demo: sum(y) = {s}, expected 6.0")
    print("simple_demo OK")


if __name__ == "__main__":
    main()
