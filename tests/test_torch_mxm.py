"""PyTorch port, ``mxm`` into a bitmap ``Matrix`` (and ``mxv``/``vxm``
on bitmap operands): a mirror of ``tests/test_mxm.py`` in parity with
the JAX package's ``gb.mxm``.

The same numpy-seeded operands (``tests.helpers.rand_om``) go through
both packages.  Patterns, integers and booleans must be equal exactly;
floats within the JAX test's own tolerances (rtol = atol = 1e-5 for
FP32, 1e-12 otherwise: the two packages sum in different orders).  The
engine each package records must agree through ``jax_engine_name``."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.ops import flopcount as jfc
from graphblas_tpu.sparse.hyper import hyper_from_coo
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.ops import mxm as tmxm

from . import oracle as orc
from .helpers import TYPES, rand_om, to_gb
from .test_mxm import SEMIRINGS


def to_gt(o: orc.OM, tname: str):
    t = getattr(gt, tname)
    if o.p.ndim == 1:
        return gt.Vector.from_dense(o.m, t, pattern=o.p, device="cpu")
    return gt.Matrix.from_dense(o.m, t, pattern=o.p, device="cpu")


def assert_same_bitmap(got, want, tol=0.0):
    """Port container ``got`` equals JAX container ``want``: type and
    pattern exactly, values exactly or (floats, ``tol``) within rtol =
    atol = tol, NaN where NaN."""
    assert got.type.name == want.type.name
    assert np.array_equal(got.pattern_np(), want.pattern_np())
    a, b = got.to_dense(), want.to_dense()
    assert a.dtype == b.dtype
    if a.dtype.kind == "f" and tol:
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    else:
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _engines_agree():
    assert gt.jax_engine_name(gt.last_axb_method()) == \
        jfc.last_axb_method(), (gt.last_axb_method(), jfc.last_axb_method())


def _mxm_both(C, M, accum, srname, tname, A, B, desc=None, ctype=None,
              atype=None, btype=None, mtype="BOOL"):
    """Run ``mxm`` on the same oracle operands in both packages; returns
    (port result, JAX result) and checks the engines agree."""
    ctype = ctype or tname
    tj = TYPES[tname]
    srj = gb.semiring[srname][tj]
    srt = gt.semiring[srname][getattr(gt, tname)]
    accj = gb.binary[accum][TYPES[ctype]] if accum else None
    acct = gt.binary[accum][getattr(gt, ctype)] if accum else None
    dj = gb.Descriptor(**(desc or {}))
    dt = gt.Descriptor(**(desc or {}))
    Cj = gb.mxm(to_gb(C, TYPES[ctype]),
                to_gb(M, TYPES[mtype]) if M is not None else None, accj,
                srj, to_gb(A, TYPES[atype or tname]),
                to_gb(B, TYPES[btype or tname]), dj)
    jm = jfc.last_axb_method()
    Ct = gt.mxm(to_gt(C, ctype), to_gt(M, mtype) if M is not None else None,
                acct, srt, to_gt(A, atype or tname), to_gt(B, btype or tname),
                dt)
    assert isinstance(Ct, gt.Matrix)
    assert gt.jax_engine_name(gt.last_axb_method()) == jm, \
        (gt.last_axb_method(), jm)
    return Ct, Cj


@pytest.mark.parametrize("addn,multn,tname", SEMIRINGS)
def test_mxm_semirings(addn, multn, tname):
    rng = np.random.default_rng(SEMIRINGS.index((addn, multn, tname)))
    t = TYPES[tname]
    A = rand_om(rng, (5, 4), t.dtype, 0.6)
    B = rand_om(rng, (4, 6), t.dtype, 0.6)
    sr = gt.semiring[f"{addn}_{multn}"][getattr(gt, tname)]
    C0 = orc.OM(np.zeros((5, 6), sr.ztype.dtype), np.zeros((5, 6), bool))
    Ct, Cj = _mxm_both(C0, None, None, f"{addn}_{multn}", tname, A, B,
                       ctype=sr.ztype.name)
    assert_same_bitmap(Ct, Cj, 1e-5 if tname == "FP32" else 1e-12)


@pytest.mark.parametrize("scmp", [False, True])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("accum", [None, "plus", "second", "max"])
def test_mxm_mask_accum(scmp, replace, accum):
    rng = np.random.default_rng(11)
    A = rand_om(rng, (5, 4), np.float64, 0.5)
    B = rand_om(rng, (4, 5), np.float64, 0.5)
    C = rand_om(rng, (5, 5), np.float64, 0.5)
    M = rand_om(rng, (5, 5), np.bool_, 0.5)
    Ct, Cj = _mxm_both(C, M, accum, "plus_times", "FP64", A, B,
                       dict(replace=replace, mask_scmp=scmp))
    assert_same_bitmap(Ct, Cj, 1e-12)


@pytest.mark.parametrize("tran0,tran1", [(True, False), (False, True),
                                         (True, True)])
def test_mxm_transpose_desc(tran0, tran1):
    rng = np.random.default_rng(12)
    A = rand_om(rng, (4, 5) if tran0 else (5, 4), np.float32, 0.6)
    B = rand_om(rng, (6, 4) if tran1 else (4, 6), np.float32, 0.6)
    C0 = orc.OM(np.zeros((5, 6), np.float32), np.zeros((5, 6), bool))
    Ct, Cj = _mxm_both(C0, None, None, "plus_times", "FP32", A, B,
                       dict(tran0=tran0, tran1=tran1))
    assert Ct.shape == (5, 6)
    assert_same_bitmap(Ct, Cj, 1e-5)


def test_mxv_vxm():
    rng = np.random.default_rng(13)
    A = rand_om(rng, (5, 4), np.float64, 0.6)
    u = rand_om(rng, (4,), np.float64, 0.7)
    v5 = rand_om(rng, (5,), np.float64, 0.7)
    srj, srt = gb.semiring.plus_times[gb.FP64], gt.semiring.plus_times[gt.FP64]
    wj = gb.mxv(gb.Vector.new(gb.FP64, 5), None, None, srj, to_gb(A, gb.FP64),
                to_gb(u, gb.FP64))
    wt = gt.mxv(gt.Vector.new(gt.FP64, 5, device="cpu"), None, None, srt,
                to_gt(A, "FP64"), to_gt(u, "FP64"))
    _engines_agree()
    assert_same_bitmap(wt, wj, 1e-12)
    wj = gb.vxm(gb.Vector.new(gb.FP64, 4), None, None, srj,
                to_gb(v5, gb.FP64), to_gb(A, gb.FP64))
    wt = gt.vxm(gt.Vector.new(gt.FP64, 4, device="cpu"), None, None, srt,
                to_gt(v5, "FP64"), to_gt(A, "FP64"))
    _engines_agree()
    assert_same_bitmap(wt, wj, 1e-12)


def test_mxm_empty_and_typecast():
    # empty B -> empty C; and an INT32 A typecast into an FP64 semiring
    rng = np.random.default_rng(14)
    A = rand_om(rng, (3, 3), np.int32, 0.5)
    B = orc.OM(np.zeros((3, 3)), np.zeros((3, 3), bool))
    C0 = orc.OM(np.zeros((3, 3)), np.zeros((3, 3), bool))
    Ct, Cj = _mxm_both(C0, None, None, "plus_times", "FP64", A, B,
                       atype="INT32")
    assert Ct.nvals() == Cj.nvals() == 0
    assert_same_bitmap(Ct, Cj)
    B2 = rand_om(rng, (3, 3), np.float64, 0.8)
    Ct, Cj = _mxm_both(C0, None, None, "plus_times", "FP64", A, B2,
                       atype="INT32")
    assert_same_bitmap(Ct, Cj, 1e-12)


def test_mxm_alias():
    # C<C> = C*C is legal (reference GB_mex_mxm_alias)
    rng = np.random.default_rng(15)
    C = rand_om(rng, (4, 4), np.bool_, 0.5)
    Cg, Ct = to_gb(C, gb.BOOL), to_gt(C, "BOOL")
    got = gt.mxm(Ct, Ct, None, gt.semiring.lor_land[gt.BOOL], Ct, Ct)
    want = gb.mxm(Cg, Cg, None, gb.semiring.lor_land[gb.BOOL], Cg, Cg)
    _engines_agree()
    assert_same_bitmap(got, want)


def test_tropical_times_not_poisoned():
    """MIN_TIMES with an absent partner must not take the identity-fill
    route: the fill would give -1 * inf = -inf; the product is the
    present pair's 6 (mirror of ``test_api.py``)."""
    Av = np.array([[2.0, -1.0]], np.float32)
    Ap = np.array([[True, True]])
    Bv = np.array([[3.0], [0.0]], np.float32)
    Bp = np.array([[True], [False]])   # B[1,0] absent
    sr = gt.semiring.min_times[gt.FP32]
    C = gt.mxm(gt.Matrix.new(gt.FP32, 1, 1, device="cpu"), None, None, sr,
               gt.Matrix.from_dense(Av, gt.FP32, pattern=Ap, device="cpu"),
               gt.Matrix.from_dense(Bv, gt.FP32, pattern=Bp, device="cpu"))
    assert C.extractElement(0, 0) == 6.0
    Cj = gb.mxm(gb.Matrix.new(gb.FP32, 1, 1), None, None,
                gb.semiring.min_times[gb.FP32],
                gb.Matrix.from_dense(Av, gb.FP32, pattern=Ap),
                gb.Matrix.from_dense(Bv, gb.FP32, pattern=Bp))
    assert Cj.extractElement(0, 0) == 6.0
    _engines_agree()
    # the gate refuses TIMES whatever the device; the fill it guards
    # against would be poisoned
    args = (torch.from_numpy(Av), torch.from_numpy(Ap), torch.from_numpy(Bv),
            torch.from_numpy(Bp), gt.FP32, gt.FP32)
    assert "TIMES" not in tmxm._TROPICAL_SAFE_MULTS
    vals, _ = tmxm._tropical_values(sr, *args)
    assert float(vals[0, 0]) == -np.inf


def test_tropical_route_gate():
    """The route takes FP32 MIN_PLUS, MAX_PLUS, MIN_MAX and MAX_MIN on
    CUDA operands only: CPU operands, other types and other pairs get
    None (and the generic path, as in the JAX package on its CPU
    backend)."""
    z = torch.zeros((2, 2))
    p = torch.ones((2, 2), dtype=torch.bool)
    for name in ("min_plus", "max_plus", "min_max", "max_min", "min_times",
                 "plus_min", "min_first"):
        for t in (gt.FP32, gt.FP64, gt.INT32):
            sr = gt.semiring[name][t]
            assert tmxm._tropical_path(sr, z.to(t.storage), p,
                                       z.to(t.storage), p, t, t) is None
    got, _, method = gt.semiring_mm(gt.semiring.min_plus[gt.FP32], z, p, z,
                                    p)
    assert method == "vpu:generic"


def test_mxm_restores_tf32_flag():
    """The full-float32 product sets TF32 off only around itself: the
    caller's setting is what it was after a plus_times[FP32] mxm."""
    rng = np.random.default_rng(16)
    A = rand_om(rng, (6, 5), np.float32, 0.7)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            gt.mxm(gt.Matrix.new(gt.FP32, 6, 6, device="cpu"), None, None,
                   gt.semiring.plus_times[gt.FP32], to_gt(A, "FP32"),
                   to_gt(A, "FP32"), gt.TRAN1)
            assert gt.last_axb_method() == "mxu:plus_times"
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_mxm_bitmap_mixed_inputs():
    """CSR operands into a bitmap C: a CSR B densifies (the dense
    engines), as in the JAX package; a bitmap mask converts too."""
    rng = np.random.default_rng(17)
    A = rand_om(rng, (6, 7), np.float64, 0.5)
    B = rand_om(rng, (7, 4), np.float64, 0.5)
    M = rand_om(rng, (6, 4), np.bool_, 0.5)
    Aj, Bj = to_gb(A, gb.FP64), to_gb(B, gb.FP64)
    At, Bt = to_gt(A, "FP64"), to_gt(B, "FP64")
    Bjc = gb.sparse.CsrMatrix.from_matrix(Bj)
    Btc = gt.CsrMatrix.from_matrix(Bt)
    Mjc = gb.sparse.CsrMatrix.from_matrix(to_gb(M, gb.BOOL))
    Mtc = gt.CsrMatrix.from_matrix(to_gt(M, "BOOL"))
    want = gb.mxm(gb.Matrix.new(gb.FP64, 6, 4), Mjc, None,
                  gb.semiring.plus_times[gb.FP64], Aj, Bjc)
    got = gt.mxm(gt.Matrix.new(gt.FP64, 6, 4, device="cpu"), Mtc, None,
                 gt.semiring.plus_times[gt.FP64], At, Btc)
    _engines_agree()
    assert_same_bitmap(got, want, 1e-12)


def test_mxm_unsupported_outputs_raise():
    rng = np.random.default_rng(18)
    A = to_gt(rand_om(rng, (4, 4), np.float32, 0.5), "FP32")
    # a JAX package HyperMatrix is not a container of the port; the
    # port's own hypersparse output takes the hypersparse engine
    H = hyper_from_coo(np.array([0]), np.array([1]), np.array([1.0]), 4, 4,
                       type=gb.FP64)
    with pytest.raises(gt.UnsupportedContainer, match="got HyperMatrix"):
        gt.mxm(H, None, None, "plus_times", A, A)
    Ht = gt.hyper_from_coo([0], [1], [1.0], 4, 4, type=gt.FP32, device="cpu")
    assert isinstance(gt.mxm(Ht, None, None, "plus_times", A, A),
                      gt.HyperMatrix)
    assert gt.last_axb_method() == "esc:hyper_spgemm"
    csc = gt.CscMatrix.from_coo([0], [1], [1.0], 4, 4, type=gt.FP32,
                                device="cpu")
    with pytest.raises(gt.UnsupportedContainer, match="CscMatrix"):
        gt.mxm(csc, None, None, "plus_times", A, A)
    with pytest.raises(gt.UnsupportedContainer, match="Vector"):
        gt.mxm(gt.Vector.new(gt.FP32, 4, device="cpu"), None, None,
               "plus_times", A, A)
    with pytest.raises(gt.DimensionMismatch):
        gt.mxm(gt.Matrix.new(gt.FP32, 3, 4, device="cpu"), None, None,
               "plus_times", A, A)
    with pytest.raises(gt.DimensionMismatch):
        gt.mxm(gt.Matrix.new(gt.FP32, 4, 4, device="cpu"),
               gt.Matrix.new(gt.BOOL, 4, 3, device="cpu"), None,
               "plus_times", A, A)
