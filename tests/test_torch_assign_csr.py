"""PyTorch port, the sparse ``assign`` / ``subassign`` / ``extract``
(``sparse/assign.py``) on ``CsrMatrix`` and ``CscMatrix``: parity with
the JAX package.

Mirrors ``tests/test_assign_csr.py`` and adds its by-column twin: the
same numpy-seeded spec matrices go through the JAX package's operation
on its CSR (or CSC) containers and through the port's; the entries must
be equal exactly (the remap, the region split, the disjoint union and
the epilogue reassociate nothing) and each result is held to the numpy
spec as the JAX test holds the JAX package."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu.sparse as jsp
from graphblas_tpu.sparse.container import CscMatrix as JCsc
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import assign as tassign

from . import oracle as orc
from .helpers import rand_om
from .test_assign import CASES, o_assign, o_subassign
from .test_esc import csr_to_om


def to_both(o: orc.OM, tname: str, kind: str = "csr"):
    """(port, JAX) sparse containers of the spec matrix ``o``."""
    I, J = np.nonzero(o.p)
    X = o.m[I, J]
    m, n = o.p.shape
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    ct, cj = (gt.CsrMatrix, JCsr) if kind == "csr" else (gt.CscMatrix, JCsc)
    return (ct.from_coo(I, J, X, m, n, type=tt, sum_duplicates=False,
                        device="cpu"),
            cj.from_coo(I, J, X, m, n, type=tj, sum_duplicates=False))


def same(got_t, got_j, want: orc.OM = None, msg=""):
    """Port result == JAX result entry for entry (same kind, type and
    storage order), and == the spec when given."""
    assert type(got_t).__name__ == type(got_j).__name__, msg
    assert got_t.type.name == got_j.type.name, msg
    assert got_t.nvals == got_j.nvals, msg
    for x, y in zip(got_t.extractTuples(), got_j.extractTuples()):
        assert np.array_equal(x, np.asarray(y)), msg
    if want is not None:
        om = csr_to_om(got_t)
        assert np.array_equal(om.p, want.p), f"{msg}: pattern vs spec"
        assert np.array_equal(om.m[om.p], want.m[want.p]), \
            f"{msg}: values vs spec"


def _op(pkg, name, tname):
    return pkg.binary[name][getattr(pkg, tname)] if name else None


@pytest.mark.parametrize("kind", ["csr", "csc"])
@pytest.mark.parametrize("accum,replace,scmp", CASES)
def test_assign_csr(accum, replace, scmp, kind):
    rng = np.random.default_rng(1)
    C = rand_om(rng, (6, 7), np.float64, 0.5)
    Ii, Jj = np.array([1, 3, 4]), np.array([0, 2, 5, 6])
    A = rand_om(rng, (3, 4), np.float64, 0.6)
    M = rand_om(rng, (6, 7), np.bool_, 0.5)
    want = o_assign(C, M, accum, A, Ii, Jj, replace, scmp)
    got = [pkg.assign(c, m, _op(pkg, accum, "FP64"), a, Ii, Jj,
                      pkg.Descriptor(replace=replace, mask_scmp=scmp))
           for pkg, c, m, a in zip((gt, gb), to_both(C, "FP64", kind),
                                   to_both(M, "BOOL"), to_both(A, "FP64"))]
    same(*got, want, f"assign {kind} {accum} {replace} {scmp}")


@pytest.mark.parametrize("kind", ["csr", "csc"])
@pytest.mark.parametrize("accum,replace,scmp", CASES)
def test_subassign_csr(accum, replace, scmp, kind):
    rng = np.random.default_rng(2)
    C = rand_om(rng, (6, 7), np.float64, 0.5)
    Ii, Jj = np.array([1, 3, 4]), np.array([0, 2, 5, 6])
    A = rand_om(rng, (3, 4), np.float64, 0.6)
    M = rand_om(rng, (3, 4), np.bool_, 0.5)
    want = o_subassign(C, M, accum, A, Ii, Jj, replace, scmp)
    got = [pkg.subassign(c, m, _op(pkg, accum, "FP64"), a, Ii, Jj,
                         pkg.Descriptor(replace=replace, mask_scmp=scmp))
           for pkg, c, m, a in zip((gt, gb), to_both(C, "FP64", kind),
                                   to_both(M, "BOOL", kind),
                                   to_both(A, "FP64", kind))]
    same(*got, want, f"subassign {kind} {accum} {replace} {scmp}")


def test_assign_csr_scalar():
    rng = np.random.default_rng(3)
    C = rand_om(rng, (5, 5), np.int32, 0.4)
    Ii, Jj = np.array([0, 2]), np.array([1, 3, 4])
    Aom = orc.OM(np.full((2, 3), 9, np.int32), np.ones((2, 3), bool))
    want = o_assign(C, None, None, Aom, Ii, Jj, dtype=np.int32)
    Ct, Cj = to_both(C, "INT32")
    same(gt.csr_assign_scalar(Ct, None, None, 9, Ii, Jj),
         jsp.csr_assign_scalar(Cj, None, None, 9, Ii, Jj), want)
    want2 = o_subassign(C, None, "plus", Aom, Ii, Jj, dtype=np.int32)
    same(gt.csr_subassign_scalar(Ct, None, gt.binary.plus[gt.INT32], 9, Ii,
                                 Jj),
         jsp.csr_subassign_scalar(Cj, None, gb.binary.plus[gb.INT32], 9, Ii,
                                  Jj), want2)
    # through the top-level forms, on the CSC twin too, with a mask
    M = rand_om(rng, (5, 5), np.bool_, 0.5)
    for kind in ("csr", "csc"):
        got = [pkg.assign_scalar(c, m, None, 4, [3, 0], None)
               for pkg, c, m in zip((gt, gb), to_both(C, "INT32", kind),
                                    to_both(M, "BOOL", kind))]
        same(*got, msg=f"assign_scalar {kind}")


def test_subref_unsorted_indices():
    rng = np.random.default_rng(4)
    A = rand_om(rng, (8, 9), np.float32, 0.5)
    Ii = np.array([6, 0, 3])          # out of order
    Jj = np.array([8, 2, 5, 1])       # out of order
    At, Aj = to_both(A, "FP32")
    Tt, Tj = gt.csr_subref(At, Ii, Jj), jsp.csr_subref(Aj, Ii, Jj)
    same(Tt, Tj, orc.OM(A.m[np.ix_(Ii, Jj)], A.p[np.ix_(Ii, Jj)]))
    # the same layout: capacity and CSR arrays one to one
    assert Tt.nzmax == Tj.nzmax
    assert np.array_equal(Tt.indptr.numpy(), np.asarray(Tj.indptr))
    ip = Tt.indptr.numpy()
    assert ip[0] == 0 and ip[-1] == Tt.nvals and np.all(np.diff(ip) >= 0)


@pytest.mark.parametrize("kind", ["csr", "csc"])
@pytest.mark.parametrize("accum,replace,scmp", CASES[:4])
def test_extract_csr(accum, replace, scmp, kind):
    rng = np.random.default_rng(5)
    C = rand_om(rng, (3, 4), np.float64, 0.5)
    A = rand_om(rng, (8, 9), np.float64, 0.5)
    M = rand_om(rng, (3, 4), np.bool_, 0.5)
    Ii, Jj = np.array([1, 3, 4]), np.array([0, 2, 5, 6])
    T = orc.OM(A.m[np.ix_(Ii, Jj)], A.p[np.ix_(Ii, Jj)])
    want = orc.o_accum_mask(C, M, T, accum, np.float64, np.float64,
                            replace, scmp)
    got = [pkg.extract(c, m, _op(pkg, accum, "FP64"), a, Ii, Jj,
                       pkg.Descriptor(replace=replace, mask_scmp=scmp))
           for pkg, c, m, a in zip((gt, gb), to_both(C, "FP64", kind),
                                   to_both(M, "BOOL"), to_both(A, "FP64"))]
    same(*got, want, f"extract {kind} {accum} {replace} {scmp}")
    # TRAN0 extracts from A'
    got = [pkg.extract(c, None, None, a, Jj[:3], Ii[::-1], pkg.TRAN0)
           for pkg, c, a in zip((gt, gb), to_both(
               orc.OM(np.zeros((3, 3)), np.zeros((3, 3), bool)), "FP64",
               kind), to_both(A, "FP64"))]
    same(*got, msg="extract TRAN0")


def test_extract_csr_A_into_bitmap():
    """A sparse A with a bitmap C: sparse subref, no global densify."""
    rng = np.random.default_rng(6)
    Com = rand_om(rng, (2, 3), np.float64, 0.5)
    A = rand_om(rng, (10, 10), np.float64, 0.4)
    Ii, Jj = np.array([4, 7]), np.array([0, 5, 9])
    T = orc.OM(A.m[np.ix_(Ii, Jj)], A.p[np.ix_(Ii, Jj)])
    want = orc.o_accum_mask(Com, None, T, None, np.float64, np.float64,
                            False, False)
    for kind in ("csr", "csc"):
        At, Aj = to_both(A, "FP64", kind)
        got_t = gt.extract(gt.Matrix.from_dense(Com.m, gt.FP64,
                                                pattern=Com.p,
                                                device="cpu"),
                           None, None, At, Ii, Jj)
        got_j = gb.extract(gb.Matrix.from_dense(Com.m, gb.FP64,
                                                pattern=Com.p),
                           None, None, Aj, Ii, Jj)
        assert np.array_equal(got_t.pattern_np(), want.p)
        assert np.array_equal(got_t.pattern_np(), got_j.pattern_np())
        assert np.array_equal(got_t.to_dense(), np.asarray(got_j.to_dense()))


def test_duplicate_indices_raise():
    rng = np.random.default_rng(7)
    Ct, Cj = to_both(rand_om(rng, (6, 6), np.float64, 0.5), "FP64")
    At, _ = to_both(rand_om(rng, (2, 2), np.float64, 0.5), "FP64")
    with pytest.raises(gt.InvalidValue):
        gt.assign(Ct, None, None, At, [1, 1], [2, 3])
    with pytest.raises(gt.InvalidValue):
        gt.csr_subref(Ct, [0, 0], [1, 2])
    with pytest.raises(gt.InvalidValue):
        gt.subassign(Ct, None, None, At, [1, 2], [3, 3])
    with pytest.raises(gb.InvalidValue):
        jsp.csr_subref(Cj, [0, 0], [1, 2])


def test_assign_csr_large_dimension():
    """n = 100,000 CsrMatrix C: assign and extract without any dense
    intermediate, equal to the JAX package's."""
    rng = np.random.default_rng(8)
    n, nnz = 100_000, 5000
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    X = rng.random(nnz)
    Ct = gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.FP64, device="cpu")
    Cj = JCsr.from_coo(I, J, X, n, n, type=gb.FP64)
    Ii = np.array([5, 70_000, 99_999])
    Jj = np.array([0, 50_000, 99_998])
    aI, aJ = np.repeat(np.arange(3), 3), np.tile(np.arange(3), 3)
    aX = np.arange(9, dtype=np.float64) + 1.0
    At = gt.CsrMatrix.from_coo(aI, aJ, aX, 3, 3, type=gt.FP64, device="cpu")
    Aj = JCsr.from_coo(aI, aJ, aX, 3, 3, type=gb.FP64)
    Gt, Gj = gt.subassign(Ct, None, None, At, Ii, Jj), \
        gb.subassign(Cj, None, None, Aj, Ii, Jj)
    same(Gt, Gj)
    vals = {(int(i), int(j)): x for i, j, x in zip(*Gt.extractTuples())}
    for a in range(3):
        for b in range(3):
            assert vals[(int(Ii[a]), int(Jj[b]))] == a * 3 + b + 1.0
    rows = [5, 6, 70_000, 99_999]
    same(gt.csr_subref(Gt, rows, None), jsp.csr_subref(Gj, rows, None))
    assert Ct.nvals == Cj.nvals   # inputs immutable


def test_key_dtype_rule():
    """Keys are int32 while (m+1)(n+1) < 2^31, int64 past it (the JAX
    package's ``_key_dtype``); both give the same entries."""
    assert tassign._key_dtype(1000, 1000) == torch.int32
    assert tassign._key_dtype(46340, 46340) == torch.int64
    assert tassign._key_dtype(1 << 20, 1 << 20) == torch.int64
    with pytest.raises(NotImplementedError):
        tassign._key_dtype(1 << 32, 1 << 32)
    n = 50_000    # int64 keys
    rng = np.random.default_rng(9)
    I = rng.integers(0, n, 300)
    J = rng.integers(0, n, 300)
    X = rng.random(300)
    Ct = gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.FP64, device="cpu")
    Cj = JCsr.from_coo(I, J, X, n, n, type=gb.FP64)
    sel = np.unique(I)[:50]
    same(gt.csr_subref(Ct, sel, None), jsp.csr_subref(Cj, sel, None))
    same(gt.assign_scalar(Ct, None, gt.binary.plus[gt.FP64], 1.5, sel,
                          sel[::-1]),
         gb.assign_scalar(Cj, None, gb.binary.plus[gb.FP64], 1.5, sel,
                          sel[::-1]))


def test_pending_and_empty_cases():
    """Pending tuples of C fold before the assign; empty regions and
    empty containers give what the JAX package gives."""
    rng = np.random.default_rng(10)
    C = rand_om(rng, (5, 6), np.float64, 0.5)
    A = rand_om(rng, (2, 2), np.float64, 0.0)     # no entries
    got = []
    for k, pkg in enumerate((gt, gb)):
        c = to_both(C, "FP64")[k].setElement(4.0, 4, 5)
        a = to_both(A, "FP64")[k]
        got.append(pkg.assign(c, None, None, a, [4, 0], [5, 1]))
    same(*got)
    got = [pkg.extract(c, None, None, a, [], [1, 2])
           for pkg, c, a in zip((gt, gb), to_both(
               orc.OM(np.zeros((0, 2)), np.zeros((0, 2), bool)), "FP64"),
               to_both(C, "FP64"))]
    same(*got)
    Rt, Rj = to_both(C, "FP64")
    same(Rt.resize(3, 3), Rj.resize(3, 3))
