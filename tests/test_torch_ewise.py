"""PyTorch port, ``eWiseAdd`` / ``eWiseMult`` / ``apply`` / ``select`` /
``transpose`` / ``kron`` into bitmap containers: a mirror of
``tests/test_ewise.py`` in parity with the JAX package.

The same numpy-seeded operands (``tests.helpers.rand_om``) go through
both packages.  Every comparison is exact, floats included (NaN where
NaN): each output entry is one IEEE operation or cast of the same
inputs in both packages."""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt

from . import oracle as orc
from .helpers import TYPES, rand_om, to_gb
from .test_ewise import OPS, TYPELIST
from .test_torch_mxm import assert_same_bitmap, to_gt


@pytest.mark.parametrize("opname", OPS)
@pytest.mark.parametrize("tname", ["BOOL", "INT32", "UINT8", "FP64"])
def test_ewise_ops(rng, opname, tname):
    t = TYPES[tname]
    A = rand_om(rng, (4, 5), t.dtype, 0.6)
    B = rand_om(rng, (4, 5), t.dtype, 0.6)
    opj = gb.binary[opname][t]
    opt = gt.binary[opname][getattr(gt, tname)]
    for union in (True, False):
        fj = gb.eWiseAdd if union else gb.eWiseMult
        ft = gt.eWiseAdd if union else gt.eWiseMult
        want = fj(gb.Matrix.new(opj.ztype, 4, 5), None, None, opj,
                  to_gb(A, t), to_gb(B, t))
        got = ft(gt.Matrix.new(opt.ztype, 4, 5, device="cpu"), None, None,
                 opt, to_gt(A, tname), to_gt(B, tname))
        assert_same_bitmap(got, want)


@pytest.mark.parametrize("tname", TYPELIST)
def test_ewise_all_types_plus(rng, tname):
    t = TYPES[tname]
    A = rand_om(rng, (3, 3), t.dtype, 0.5)
    B = rand_om(rng, (3, 3), t.dtype, 0.5)
    want = gb.eWiseAdd(gb.Matrix.new(t, 3, 3), None, None, gb.binary.plus[t],
                       to_gb(A, t), to_gb(B, t))
    tt = getattr(gt, tname)
    got = gt.eWiseAdd(gt.Matrix.new(tt, 3, 3, device="cpu"), None, None,
                      gt.binary.plus[tt], to_gt(A, tname), to_gt(B, tname))
    assert_same_bitmap(got, want)
    assert np.array_equal(got.to_dense(),
                          orc.o_ewise("plus", t.dtype, A, B, True).m)


def test_ewise_mask_accum_vector(rng):
    t = gb.INT32
    A = rand_om(rng, (6,), t.dtype, 0.5)
    B = rand_om(rng, (6,), t.dtype, 0.5)
    C = rand_om(rng, (6,), t.dtype, 0.5)
    M = rand_om(rng, (6,), np.bool_, 0.5)
    want = gb.eWiseAdd(to_gb(C, t), to_gb(M, gb.BOOL), gb.binary.plus[t],
                       gb.binary.max[t], to_gb(A, t), to_gb(B, t),
                       gb.REPLACE)
    got = gt.eWiseAdd(to_gt(C, "INT32"), to_gt(M, "BOOL"),
                      gt.binary.plus[gt.INT32], gt.binary.max[gt.INT32],
                      to_gt(A, "INT32"), to_gt(B, "INT32"), gt.REPLACE)
    assert isinstance(got, gt.Vector)
    assert_same_bitmap(got, want)


def test_ewise_add_minus_keeps_b_only_entries(rng):
    """GB_add's typecast rule: an entry on one side only is cast to
    ztype with no op applied, so B-only entries stay b, not -b."""
    A = rand_om(rng, (5, 5), np.int16, 0.4)
    B = rand_om(rng, (5, 5), np.int16, 0.6)
    got = gt.eWiseAdd(gt.Matrix.new(gt.INT16, 5, 5, device="cpu"), None,
                      None, "minus", to_gt(A, "INT16"), to_gt(B, "INT16"))
    bonly = B.p & ~A.p
    assert bonly.any()
    assert np.array_equal(got.to_dense()[bonly], B.m[bonly])
    want = gb.eWiseAdd(gb.Matrix.new(gb.INT16, 5, 5), None, None, "minus",
                       to_gb(A, gb.INT16), to_gb(B, gb.INT16))
    assert_same_bitmap(got, want)


@pytest.mark.parametrize("opname", ["identity", "ainv", "minv", "lnot",
                                    "one", "abs"])
@pytest.mark.parametrize("tname", ["BOOL", "INT8", "UINT16", "INT64", "FP64"])
def test_apply(rng, opname, tname):
    t = TYPES[tname]
    A = rand_om(rng, (4, 4), t.dtype, 0.6)
    want = gb.apply(gb.Matrix.new(t, 4, 4), None, None, gb.unary[opname][t],
                    to_gb(A, t))
    tt = getattr(gt, tname)
    got = gt.apply(gt.Matrix.new(tt, 4, 4, device="cpu"), None, None,
                   gt.unary[opname][tt], to_gt(A, tname))
    assert_same_bitmap(got, want)


def test_apply_typecast_to_output(rng):
    A = rand_om(rng, (3, 3), np.float64, 0.8)
    C = rand_om(rng, (3, 3), np.int32, 0.5)
    want = gb.apply(to_gb(C, gb.INT32), None, gb.binary.plus[gb.INT32],
                    gb.unary.ainv[gb.FP64], to_gb(A, gb.FP64))
    got = gt.apply(to_gt(C, "INT32"), None, gt.binary.plus[gt.INT32],
                   gt.unary.ainv[gt.FP64], to_gt(A, "FP64"))
    assert_same_bitmap(got, want)


@pytest.mark.parametrize("selname,k", [("tril", 0), ("tril", -1),
                                       ("triu", 0), ("triu", 2),
                                       ("diag", 0), ("offdiag", 0),
                                       ("nonzero", 0)])
def test_select(rng, selname, k):
    A = rand_om(rng, (5, 5), np.float64, 0.7)
    want = gb.select(gb.Matrix.new(gb.FP64, 5, 5), None, None,
                     gb.selectop[selname], to_gb(A, gb.FP64), k)
    got = gt.select(gt.Matrix.new(gt.FP64, 5, 5, device="cpu"), None, None,
                    gt.selectop[selname], to_gt(A, "FP64"), k)
    assert_same_bitmap(got, want)


def test_transpose_full(rng):
    A = rand_om(rng, (4, 6), np.float64, 0.5)
    C = rand_om(rng, (6, 4), np.float64, 0.5)
    want = gb.transpose(to_gb(C, gb.FP64), None, gb.binary.plus[gb.FP64],
                        to_gb(A, gb.FP64))
    got = gt.transpose(to_gt(C, "FP64"), None, gt.binary.plus[gt.FP64],
                       to_gt(A, "FP64"))
    assert_same_bitmap(got, want)


def test_kron(rng):
    A = rand_om(rng, (2, 3), np.float64, 0.7)
    B = rand_om(rng, (3, 2), np.float64, 0.7)
    want = gb.kron(gb.Matrix.new(gb.FP64, 6, 6), None, None,
                   gb.binary.times[gb.FP64], to_gb(A, gb.FP64),
                   to_gb(B, gb.FP64))
    got = gt.kron(gt.Matrix.new(gt.FP64, 6, 6, device="cpu"), None, None,
                  gt.binary.times[gt.FP64], to_gt(A, "FP64"),
                  to_gt(B, "FP64"))
    assert_same_bitmap(got, want)


def test_udt_op_raises_typed():
    """An op whose types are not the port's Types (here the JAX
    package's) raises a typed error before any work; a port op over a
    user-defined type meets builtin values with the cast rule's
    TypeError, as the JAX package's cast does."""
    udt = gb.Type.udt("PAIR", a=gb.FP64, b=gb.INT64)
    op = gt.UnaryOp("UDT_ID", lambda x: x, udt, udt)
    A = gt.Matrix.new(gt.FP64, 2, 2, device="cpu")
    with pytest.raises(gt.UnsupportedOp, match="not a GraphBLAS Type"):
        gt.apply(gt.Matrix.new(gt.FP64, 2, 2, device="cpu"), None, None, op,
                 A)
    bop = gt.BinaryOp("UDT_PLUS", lambda x, y: x, udt, udt, udt)
    with pytest.raises(gt.UnsupportedOp, match="not a GraphBLAS Type"):
        gt.eWiseAdd(A, None, None, bop, A, A)
    pudt = gt.Type.udt("PAIR", a=gt.FP64, b=gt.INT64)
    pop = gt.UnaryOp("UDT_ID", lambda x: x, pudt, pudt)
    A = A.setElement(1.0, 0, 0).wait()
    with pytest.raises(TypeError, match="user-defined"):
        gt.apply(gt.Matrix.new(pudt, 2, 2, device="cpu"), None, None, pop,
                 A)
    from graphblas_tpu.core.types import cast as jcast
    with pytest.raises(TypeError, match="user-defined"):
        jcast(np.ones(2), udt)
