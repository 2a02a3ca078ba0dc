"""PyTorch port, ``assign`` / ``subassign`` / ``extract`` and their
scalar, vector, row and column forms on the bitmap ``Matrix`` and
``Vector``: parity with the JAX package.

Mirrors ``tests/test_assign.py``: the same numpy-seeded spec matrices
go through the JAX package's operation and the port's; the outputs must
be equal exactly (pattern, type and values: the gather, the accum/mask
epilogue and the scatter reassociate nothing), and each is also held to
the numpy spec (``tests/oracle.py``, ``GB_spec_assign.m`` /
``GB_spec_subassign.m``) as the JAX test holds the JAX package.  Assign
indices are unique (duplicate assign indices are undefined in the
spec); extract indices may repeat."""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt

from . import oracle as orc
from .helpers import rand_om
from .test_assign import CASES, _index_kinds, o_assign, o_subassign


def to_both(o: orc.OM, tname: str):
    """(port, JAX) bitmap containers of the spec matrix ``o``."""
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    if o.p.ndim == 1:
        return (gt.Vector.from_dense(o.m, tt, pattern=o.p, device="cpu"),
                gb.Vector.from_dense(o.m, tj, pattern=o.p))
    return (gt.Matrix.from_dense(o.m, tt, pattern=o.p, device="cpu"),
            gb.Matrix.from_dense(o.m, tj, pattern=o.p))


def same(got_t, got_j, want: orc.OM = None, msg=""):
    """Port result == JAX result exactly, and == the spec when given."""
    assert got_t.type.name == got_j.type.name, msg
    pt = got_t.pattern_np()
    vt = got_t.to_dense()
    assert np.array_equal(pt, np.asarray(got_j.wait().pattern)), msg
    assert np.array_equal(vt, np.asarray(got_j.wait().values)), msg
    if want is not None:
        assert np.array_equal(pt, want.p), f"{msg}: pattern vs spec"
        assert np.array_equal(vt[want.p], want.m[want.p]), \
            f"{msg}: values vs spec"


def _op(pkg, name, tname):
    return pkg.binary[name][getattr(pkg, tname)] if name else None


def _desc(pkg, replace, scmp):
    return pkg.Descriptor(replace=replace, mask_scmp=scmp)


@pytest.mark.parametrize("accum,replace,scmp", CASES)
def test_assign_matrix(accum, replace, scmp):
    rng = np.random.default_rng(1)
    C = rand_om(rng, (6, 7), np.float64, 0.5)
    Ii, Jj = np.array([1, 3, 4]), np.array([0, 2, 5, 6])
    A = rand_om(rng, (3, 4), np.float64, 0.6)
    M = rand_om(rng, (6, 7), np.bool_, 0.5)
    want = o_assign(C, M, accum, A, Ii, Jj, replace, scmp)
    got = [pkg.assign(c, m, _op(pkg, accum, "FP64"), a, Ii, Jj,
                      _desc(pkg, replace, scmp))
           for pkg, c, m, a in zip((gt, gb), to_both(C, "FP64"),
                                   to_both(M, "BOOL"), to_both(A, "FP64"))]
    same(*got, want, f"assign {accum} r={replace} s={scmp}")


@pytest.mark.parametrize("accum,replace,scmp", CASES)
def test_subassign_matrix(accum, replace, scmp):
    rng = np.random.default_rng(2)
    C = rand_om(rng, (6, 7), np.float64, 0.5)
    Ii, Jj = np.array([1, 3, 4]), np.array([0, 2, 5, 6])
    A = rand_om(rng, (3, 4), np.float64, 0.6)
    M = rand_om(rng, (3, 4), np.bool_, 0.5)   # submatrix-sized mask
    want = o_subassign(C, M, accum, A, Ii, Jj, replace, scmp)
    got = [pkg.subassign(c, m, _op(pkg, accum, "FP64"), a, Ii, Jj,
                         _desc(pkg, replace, scmp))
           for pkg, c, m, a in zip((gt, gb), to_both(C, "FP64"),
                                   to_both(M, "BOOL"), to_both(A, "FP64"))]
    same(*got, want, f"subassign {accum} r={replace} s={scmp}")


def test_assign_scalar_expansion():
    rng = np.random.default_rng(3)
    C = rand_om(rng, (5, 5), np.int32, 0.4)
    Ii, Jj = np.array([0, 2]), np.array([1, 3, 4])
    Aom = orc.OM(np.full((2, 3), 9, np.int32), np.ones((2, 3), bool))
    want = o_assign(C, None, None, Aom, Ii, Jj, dtype=np.int32)
    got = [pkg.assign_scalar(c, None, None, 9, Ii, Jj)
           for pkg, c in zip((gt, gb), to_both(C, "INT32"))]
    same(*got, want)
    # masked scalar assign of the whole matrix (the BFS v<q>=level idiom)
    M = rand_om(rng, (5, 5), np.bool_, 0.5)
    IA = np.arange(5)
    Aall = orc.OM(np.full((5, 5), 7, np.int32), np.ones((5, 5), bool))
    want2 = o_assign(C, M, None, Aall, IA, IA, dtype=np.int32)
    got2 = [pkg.assign_scalar(c, m, None, 7)
            for pkg, c, m in zip((gt, gb), to_both(C, "INT32"),
                                 to_both(M, "BOOL"))]
    same(*got2, want2)
    # subassign of a scalar, with ALL spelled three ways
    for ALL in (None, "ALL", slice(None)):
        got3 = [pkg.subassign_scalar(c, None, _op(pkg, "plus", "INT32"), 2,
                                     pkg.ALL if ALL == "ALL" else ALL,
                                     [4, 1])
                for pkg, c in zip((gt, gb), to_both(C, "INT32"))]
        same(*got3)


def test_assign_vector_and_scalar():
    rng = np.random.default_rng(4)
    w = rand_om(rng, (6,), np.float64, 0.5)
    u = rand_om(rng, (3,), np.float64, 0.8)
    Ii = np.array([0, 2, 5])
    wm = orc.OM(w.m[:, None], w.p[:, None])
    um = orc.OM(u.m[:, None], u.p[:, None])
    want = o_assign(wm, None, "plus", um, Ii, np.array([0]))
    got = [pkg.assign_vector(ww, None, _op(pkg, "plus", "FP64"), uu, Ii)
           for pkg, ww, uu in zip((gt, gb), to_both(w, "FP64"),
                                  to_both(u, "FP64"))]
    same(*got, orc.OM(want.m[:, 0], want.p[:, 0]))
    # scalar with mask + replace (BFS style on vectors)
    m = rand_om(rng, (6,), np.bool_, 0.5)
    mm = orc.OM(m.m[:, None], m.p[:, None])
    Aall = orc.OM(np.full((6, 1), 3.5), np.ones((6, 1), bool))
    want2 = o_assign(wm, mm, None, Aall, np.arange(6), np.array([0]),
                     replace=True)
    got2 = [pkg.assign_vector(ww, mk, None, 3.5, desc=pkg.REPLACE,
                              scalar=True)
            for pkg, ww, mk in zip((gt, gb), to_both(w, "FP64"),
                                   to_both(m, "BOOL"))]
    same(*got2, orc.OM(want2.m[:, 0], want2.p[:, 0]))
    # subassign_vector, mask the size of I
    ms = rand_om(rng, (3,), np.bool_, 0.6)
    got3 = [pkg.subassign_vector(ww, mk, _op(pkg, "max", "FP64"), uu, Ii)
            for pkg, ww, mk, uu in zip((gt, gb), to_both(w, "FP64"),
                                       to_both(ms, "BOOL"),
                                       to_both(u, "FP64"))]
    same(*got3)
    # a valued mask: explicit zeros of v are not in it (bfs5m's v<v> = v)
    v = rand_om(rng, (6,), np.int32, 0.8)
    got4 = [pkg.assign_vector(vv, vv, None, vv, None, pkg.REPLACE)
            for pkg, vv in zip((gt, gb), to_both(v, "INT32"))]
    same(*got4)
    assert not (got4[0].to_dense()[got4[0].pattern_np()] == 0).any()


def test_row_col_assign():
    rng = np.random.default_rng(5)
    C = rand_om(rng, (5, 6), np.float64, 0.5)
    u = rand_om(rng, (6,), np.float64, 0.7)
    Cm = C.copy()
    S = orc.OM(Cm.m[2, :], Cm.p[2, :])
    Z = orc.o_accum("plus", np.float64, S, u, np.float64)
    Cm.m[2, :] = Z.m
    Cm.p[2, :] = Z.p
    got = [pkg.row_assign(c, None, _op(pkg, "plus", "FP64"), uu, 2)
           for pkg, c, uu in zip((gt, gb), to_both(C, "FP64"),
                                 to_both(u, "FP64"))]
    same(*got, Cm)
    v = rand_om(rng, (5,), np.float64, 0.7)
    m = rand_om(rng, (5,), np.bool_, 0.6)
    Cm2 = C.copy()
    S2 = orc.OM(Cm2.m[:, 3], Cm2.p[:, 3])
    Z2 = orc.o_accum(None, np.float64, S2, v, np.float64)
    R2 = orc.o_mask(S2, m, Z2, False, False)
    Cm2.m[:, 3] = R2.m
    Cm2.p[:, 3] = R2.p
    got2 = [pkg.col_assign(c, mk, None, vv, None, 3)
            for pkg, c, mk, vv in zip((gt, gb), to_both(C, "FP64"),
                                      to_both(m, "BOOL"),
                                      to_both(v, "FP64"))]
    same(*got2, Cm2)


def test_extract():
    rng = np.random.default_rng(6)
    A = rand_om(rng, (6, 7), np.float64, 0.5)
    Ii = np.array([5, 0, 3])
    Jj = np.array([1, 1, 6, 2])   # duplicates allowed in extract
    want = orc.OM(A.m[np.ix_(Ii, Jj)], A.p[np.ix_(Ii, Jj)])
    got = [pkg.extract(pkg.Matrix.new(pkg.FP64, 3, 4, **kw), None, None, a,
                       Ii, Jj)
           for pkg, a, kw in zip((gt, gb), to_both(A, "FP64"),
                                 ({"device": "cpu"}, {}))]
    same(*got, want)
    wantT = orc.OM(A.m.T[np.ix_(Jj, Ii)], A.p.T[np.ix_(Jj, Ii)])
    gotT = [pkg.extract(pkg.Matrix.new(pkg.FP64, 4, 3, **kw), None, None, a,
                        Jj, Ii, pkg.TRAN0)
            for pkg, a, kw in zip((gt, gb), to_both(A, "FP64"),
                                  ({"device": "cpu"}, {}))]
    same(*gotT, wantT)
    wantc = orc.OM(A.m[Ii, 2], A.p[Ii, 2])
    gotc = [pkg.extract_col(pkg.Vector.new(pkg.FP64, 3, **kw), None, None,
                            a, Ii, 2)
            for pkg, a, kw in zip((gt, gb), to_both(A, "FP64"),
                                  ({"device": "cpu"}, {}))]
    same(*gotc, wantc)
    gotr = [pkg.extract_col(pkg.Vector.new(pkg.FP64, 4, **kw), None, None,
                            a, Jj, 4, pkg.TRAN0)
            for pkg, a, kw in zip((gt, gb), to_both(A, "FP64"),
                                  ({"device": "cpu"}, {}))]
    same(*gotr, orc.OM(A.m[4, Jj], A.p[4, Jj]))
    u = rand_om(rng, (8,), np.int64, 0.6)
    m = rand_om(rng, (5,), np.bool_, 0.6)
    gotv = [pkg.extract_vector(pkg.Vector.new(pkg.INT64, 5, **kw), mk,
                               _op(pkg, "plus", "INT64"), uu,
                               [7, 0, 7, 3, 1])
            for pkg, uu, mk, kw in zip((gt, gb), to_both(u, "INT64"),
                                       to_both(m, "BOOL"),
                                       ({"device": "cpu"}, {}))]
    same(*gotv)


def test_build_dup_and_extractTuples():
    I = [0, 1, 0, 1, 0]
    J = [0, 1, 0, 1, 1]
    X = [1.0, 2.0, 10.0, 30.0, 5.0]
    A = gt.Matrix.from_coo(I, J, X, 2, 2, type=gt.FP64, device="cpu")
    assert A.extractElement(0, 0) == 11.0
    assert A.extractElement(1, 1) == 32.0
    assert A.extractElement(0, 1) == 5.0
    Ii, Jj, Xx = A.extractTuples()
    assert list(Ii) == [0, 0, 1] and list(Jj) == [0, 1, 1]
    assert list(Xx) == [11.0, 5.0, 32.0]
    B = gt.Matrix.from_coo(I, J, X, 2, 2, type=gt.FP64,
                           dup=gt.binary.second[gt.FP64], device="cpu")
    assert B.extractElement(0, 0) == 10.0


def test_resize_clear():
    rng = np.random.default_rng(7)
    A = rand_om(rng, (4, 4), np.int32, 0.8)
    Gt, Gj = to_both(A, "INT32")
    for shape in [(6, 5), (2, 2)]:
        same(Gt.resize(*shape), Gj.resize(*shape))
    assert Gt.resize(6, 5).nvals() == int(A.p.sum())
    assert Gt.clear().nvals() == 0


@pytest.mark.parametrize("tname", ["FP64", "INT32", "BOOL", "UINT8"])
def test_assign_sweep(tname):
    """The randomized sweep over index kinds (ALL, range, stride,
    backwards, explicit list) x types x masks x accum x descriptors."""
    rng = np.random.default_rng(8)
    dt = getattr(gb, tname).dtype
    n, m = 8, 9
    for trial in range(5):
        C = rand_om(rng, (n, m), dt, 0.5)
        Ii = _index_kinds(rng, n)[trial % 5]
        Jj = _index_kinds(rng, m)[(trial + 2) % 5]
        A = rand_om(rng, (len(Ii), len(Jj)), dt, 0.6)
        M = rand_om(rng, (n, m), np.bool_, 0.5) if trial % 2 else None
        accum = [None, "plus", "times", "min"][trial % 4]
        if dt == np.bool_ and accum in ("plus", "times", "min"):
            accum = "lor"
        replace, scmp = trial % 3 == 0, trial % 4 == 1
        want = o_assign(C, M, accum, A, Ii, Jj, replace, scmp, dtype=dt)
        got = []
        for k, pkg in enumerate((gt, gb)):
            c, a = to_both(C, tname)[k], to_both(A, tname)[k]
            mk = to_both(M, "BOOL")[k] if M is not None else None
            got.append(pkg.assign(c, mk, _op(pkg, accum, tname), a, Ii, Jj,
                                  _desc(pkg, replace, scmp)))
        same(*got, want, f"assign sweep {tname} trial {trial}")


@pytest.mark.parametrize("tname", ["FP64", "INT32", "BOOL"])
def test_subassign_sweep(tname):
    rng = np.random.default_rng(9)
    dt = getattr(gb, tname).dtype
    n, m = 8, 9
    for trial in range(5):
        C = rand_om(rng, (n, m), dt, 0.5)
        Ii = _index_kinds(rng, n)[(trial + 1) % 5]
        Jj = _index_kinds(rng, m)[(trial + 3) % 5]
        A = rand_om(rng, (len(Ii), len(Jj)), dt, 0.6)
        M = rand_om(rng, (len(Ii), len(Jj)), np.bool_, 0.5) \
            if trial % 2 else None
        accum = [None, "plus", "max", "second"][trial % 4]
        if dt == np.bool_ and accum in ("plus", "max"):
            accum = "land"
        replace, scmp = trial % 2 == 1, trial % 3 == 2
        want = o_subassign(C, M, accum, A, Ii, Jj, replace, scmp, dtype=dt)
        got = []
        for k, pkg in enumerate((gt, gb)):
            c, a = to_both(C, tname)[k], to_both(A, tname)[k]
            mk = to_both(M, "BOOL")[k] if M is not None else None
            got.append(pkg.subassign(c, mk, _op(pkg, accum, tname), a, Ii,
                                     Jj, _desc(pkg, replace, scmp)))
        same(*got, want, f"subassign sweep {tname} trial {trial}")


def test_scalar_assign_sweep():
    rng = np.random.default_rng(10)
    n, m = 7, 6
    for trial in range(4):
        C = rand_om(rng, (n, m), np.float64, 0.5)
        Ii = _index_kinds(rng, n)[trial % 5]
        Jj = _index_kinds(rng, m)[(trial + 1) % 5]
        x = float(rng.normal())
        M = rand_om(rng, (n, m), np.bool_, 0.5)
        Iu, Ju = np.unique(Ii), np.unique(Jj)
        A = orc.OM(np.full((len(Iu), len(Ju)), x),
                   np.ones((len(Iu), len(Ju)), bool))
        want = o_assign(C, M, "plus", A, Iu, Ju, False, False)
        got = [pkg.assign_scalar(c, mk, _op(pkg, "plus", "FP64"), x, Ii, Jj)
               for pkg, c, mk in zip((gt, gb), to_both(C, "FP64"),
                                     to_both(M, "BOOL"))]
        same(*got, want, f"scalar assign trial {trial}")


def test_typecast_assign():
    rng = np.random.default_rng(11)
    C = rand_om(rng, (5, 5), np.float64, 0.5)
    A = rand_om(rng, (2, 3), np.int32, 0.8)
    Ii, Jj = np.array([0, 2]), np.array([1, 3, 4])
    want = o_assign(C, None, None, orc.OM(A.m.astype(np.float64), A.p),
                    Ii, Jj)
    got = [pkg.assign(c, None, None, a, Ii, Jj)
           for pkg, c, a in zip((gt, gb), to_both(C, "FP64"),
                                to_both(A, "INT32"))]
    same(*got, want, "typecast assign")


def test_pending_operands_fold_first():
    """Pending tuples of C, the mask and A fold before the operation."""
    rng = np.random.default_rng(12)
    C = rand_om(rng, (4, 4), np.float64, 0.5)
    A = rand_om(rng, (2, 2), np.float64, 0.5)
    M = rand_om(rng, (4, 4), np.bool_, 0.5)
    got = []
    for k, pkg in enumerate((gt, gb)):
        c = to_both(C, "FP64")[k].setElement(5.0, 1, 1, blocking=False)
        a = to_both(A, "FP64")[k].setElement(2.0, 0, 1, blocking=False)
        mk = to_both(M, "BOOL")[k].setElement(True, 3, 3, blocking=False)
        got.append(pkg.assign(c, mk, None, a, [3, 1], [1, 3]))
    same(*got)


def test_unported_containers_raise():
    """A non-container raises the typed error naming the containers
    (the hypersparse ones among them since the hypersparse slice)."""
    C = gt.Matrix.new(gt.FP64, 3, 3, device="cpu")
    for fn in (lambda: gt.assign(object(), None, None, C),
               lambda: gt.subassign(C, None, None, object()),
               lambda: gt.extract(object(), None, None, C),
               lambda: gt.assign_vector(object(), None, None, 1.0,
                                        scalar=True),
               lambda: gt.extract_vector(object(), None, None, C)):
        with pytest.raises(gt.UnsupportedContainer,
                           match="HyperMatrix, SparseVec"):
            fn()
    with pytest.raises(gt.DimensionMismatch):
        gt.assign(C, None, None, gt.Matrix.new(gt.FP64, 2, 2, device="cpu"),
                  [0, 1, 2], [0])
    with pytest.raises(gt.IndexOutOfBounds):
        gt.extract(gt.Matrix.new(gt.FP64, 1, 1, device="cpu"), None, None,
                   C, [3], [0])
