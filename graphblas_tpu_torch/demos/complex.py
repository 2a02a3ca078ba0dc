"""Complex-arithmetic demo (reference ``Demo/Program/complex_demo.c`` +
``Demo/Source/usercomplex.c``: a full double-complex op set as user
objects).  Here complex is a native dtype; the demo runs C = A*B over
the user-defined complex plus-times semiring and verifies against numpy.

Usage: python -m graphblas_tpu_torch.demos.complex [--device DEV]
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.demos._common import demo_args
from graphblas_tpu_torch.user_objects import my_complex_plus_times


def main(argv=None):
    dev, _ = demo_args(argv)
    rng = np.random.default_rng(0)
    m, k, n = 4, 5, 3
    Ad = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k)))
    Bd = (rng.normal(size=(k, n)) + 1j * rng.normal(size=(k, n)))
    Am = rng.random((m, k)) < 0.7
    Bm = rng.random((k, n)) < 0.7
    A = gt.Matrix.from_dense(Ad * Am, gt.FC64, pattern=Am, device=dev)
    B = gt.Matrix.from_dense(Bd * Bm, gt.FC64, pattern=Bm, device=dev)
    C = gt.mxm(gt.Matrix.new(gt.FC64, m, n, device=dev), None, None,
               my_complex_plus_times, A, B)
    want = (Ad * Am) @ (Bd * Bm)
    if not np.allclose(C.to_dense(), want):
        raise SystemExit("complex_demo: C differs from numpy's A @ B")
    gt.fprint(C, "C = A*B (complex)", gt.SUMMARY)
    print("complex_demo OK")


if __name__ == "__main__":
    main()
