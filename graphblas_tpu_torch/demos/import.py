"""Import/export demo (reference ``Demo/Program/import_demo.c``):
round-trip a matrix through CSR/CSC import/export.

Usage: python -m graphblas_tpu_torch.demos.import [--device DEV]
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, _ = demo_args(argv)
    rng = np.random.default_rng(1)
    mask = rng.random((6, 7)) < 0.4
    dense = rng.normal(size=(6, 7)) * mask
    A = gt.Matrix.from_dense(dense, gt.FP64, pattern=mask, device=dev)

    nr, nc, indptr, indices, values = gt.export_csr(A)
    print(f"exported CSR: {nr}x{nc}, nvals={len(indices)}")
    B = gt.import_csr(nr, nc, indptr, indices, values, gt.FP64, device=dev)
    if not np.allclose(B.to_matrix().to_dense(), dense):
        raise SystemExit("import_demo: the CSR round trip differs")

    nr, nc, cp, ri, cv = gt.export_csc(A)
    print(f"exported CSC: {nr}x{nc}, nvals={len(ri)}")
    C = gt.import_csc(nr, nc, cp, ri, cv, gt.FP64, device=dev)
    if not np.allclose(C.to_matrix().to_dense(), dense):
        raise SystemExit("import_demo: the CSC round trip differs")
    print("import_demo OK")


if __name__ == "__main__":
    main()
