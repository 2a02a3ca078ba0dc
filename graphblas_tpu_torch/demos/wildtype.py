"""Arbitrary user-defined struct types (reference
``Demo/Program/wildtype_demo.c``: a struct containing a 4x4 float
matrix + a string-like tag, with user ops/semiring over it).

Here the "wildtype" is a struct type stored field by field, one tensor
per field, with user ops over dicts of tensors.

Usage: python -m graphblas_tpu_torch.demos.wildtype [--device DEV]
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core.monoids import monoid_new
from graphblas_tpu_torch.core.ops import BinaryOp
from graphblas_tpu_torch.core.semirings import semiring_new
from graphblas_tpu_torch.core.types import Type
from graphblas_tpu_torch.demos._common import demo_args


def main(argv=None):
    dev, _ = demo_args(argv)
    # wildtype: {stuff: fp64, more: fp32}  (struct-of-arrays UDT)
    wild = Type.udt("wildtype", stuff=gt.FP64, more=gt.FP32)

    wadd = BinaryOp("WILDADD", lambda x, y: {
        "stuff": x["stuff"] + y["stuff"],
        "more": x["more"] + y["more"]}, wild, wild, wild)
    wmult = BinaryOp("WILDMULT", lambda x, y: {
        "stuff": x["stuff"] * y["stuff"],
        "more": x["more"] * y["more"]}, wild, wild, wild)
    wmonoid = monoid_new(wadd, {"stuff": 0.0, "more": 0.0})
    wsemiring = semiring_new(wmonoid, wmult)

    C = gt.Matrix.new(wild, 4, 4, device=dev)
    C = C.setElement({"stuff": 4.5, "more": 3.2}, 0, 0)
    C = C.setElement({"stuff": 1.0, "more": 2.0}, 0, 3)
    C = C.setElement({"stuff": 3.0, "more": 1.0}, 3, 0)
    gt.fprint(C, "C", gt.SHORT)

    D = gt.mxm(gt.Matrix.new(wild, 4, 4, device=dev), None, None,
               wsemiring, C, C)
    gt.fprint(D, "D = C*C", gt.SHORT)
    d00 = D.extractElement(0, 0)
    if not np.isclose(d00["stuff"], 4.5 * 4.5 + 1.0 * 3.0):
        raise SystemExit(f"wildtype_demo: D(0,0) = {d00}")
    print("wildtype_demo OK")


if __name__ == "__main__":
    main()
