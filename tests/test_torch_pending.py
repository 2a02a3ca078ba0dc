"""PyTorch port, pending tuples and element mutation (``setElement`` /
``wait`` / ``extractElement`` / ``removeElement`` / ``resize`` /
``clear``) on ``CsrMatrix``, ``CscMatrix`` and the bitmap ``Matrix`` and
``Vector``: parity with the JAX package.

Mirrors the CSR, CSC and hypersparse cases of
``tests/test_pending_sparse.py``, the pending part of
``tests/test_assign.py``, and the container parts of ``tests/test_csc.py``
and ``tests/test_sparse.py`` that this slice adds (``colptr``/``rowidx``
views, ``row_degrees``/``col_degrees``).  The same operations run on a
JAX container and on the port's, built from the same numpy-seeded
tuples; every result must be equal exactly (the folds run in the same
order on the host)."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.sparse.container import CscMatrix as JCsc
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
from graphblas_tpu.sparse.hyper import HyperMatrix as JHyper
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.convert import from_jax
from graphblas_tpu_torch.sparse import pending as tpending

KINDS = ["csr", "csc", "hyper"]


def mk(kind, I, J, X, m, n, tname="FP64"):
    """(port, JAX) containers of one kind from the same tuples."""
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    if kind == "csr":
        return (gt.CsrMatrix.from_coo(I, J, X, m, n, type=tt,
                                      sum_duplicates=False, device="cpu"),
                JCsr.from_coo(I, J, X, m, n, type=tj, sum_duplicates=False))
    if kind == "hyper":
        return (gt.HyperMatrix.from_coo(I, J, X, m, n, type=tt, dup=None,
                                        device="cpu"),
                JHyper.from_coo(I, J, X, m, n, type=tj, dup=None))
    return (gt.CscMatrix.from_coo(I, J, X, m, n, type=tt,
                                  sum_duplicates=False, device="cpu"),
            JCsc.from_coo(I, J, X, m, n, type=tj, sum_duplicates=False))


def tuples_of(A):
    I, J, X = A.extractTuples()
    return {(int(i), int(j)): x.item() for i, j, x in zip(I, J, X)}


def same(At, Aj):
    """The port's container holds the JAX container's entries, in the
    same storage order, with equal values and dtypes."""
    for x, y in zip(At.extractTuples(), Aj.extractTuples()):
        y = np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), (x, y)
    assert At.shape == tuple(Aj.shape)


def both(fn, At, Aj):
    return fn(At, gt), fn(Aj, gb)


def _pending_of(A):
    return A.tr._pending if isinstance(A, (gt.CscMatrix, JCsc)) \
        else A._pending


@pytest.mark.parametrize("kind", KINDS)
def test_set_extract_remove_roundtrip(kind):
    At, Aj = mk(kind, [0, 2, 2], [1, 0, 3], [1.0, 2.0, 3.0], 5, 6)

    def step(A, pkg):
        return A.setElement(9.0, 2, 0).setElement(7.0, 4, 5)
    At, Aj = both(step, At, Aj)
    assert _pending_of(At) and len(_pending_of(At)) == 2
    for ij in [(2, 0), (4, 5), (0, 1), (1, 1)]:
        assert At.extractElement(*ij) == Aj.extractElement(*ij)
    assert At.extractElement(1, 1) is None
    same(At, Aj)
    assert tuples_of(At) == {(0, 1): 1.0, (2, 0): 9.0, (2, 3): 3.0,
                             (4, 5): 7.0}
    Bt, Bj = At.removeElement(2, 3), Aj.removeElement(2, 3)
    assert Bt.extractElement(2, 3) is None
    same(Bt, Bj)
    # removing an absent entry is a no-op (reference: zombie of nothing)
    same(Bt.removeElement(1, 1), Bj.removeElement(1, 1))
    with pytest.raises(gt.IndexOutOfBounds):
        At.setElement(1.0, 5, 0)
    with pytest.raises(gt.IndexOutOfBounds):
        At.extractElement(0, 6)
    with pytest.raises(gt.IndexOutOfBounds):
        At.removeElement(-1, 0)


@pytest.mark.parametrize("kind", KINDS)
def test_setelement_accum_and_dup_fold(kind):
    def plus(pkg):
        return pkg.binary.plus[pkg.FP64]

    def run_a(A, pkg):
        # accum against an existing entry; dup fold within the pending run
        return (A.setElement(1.0, 1, 1, accum=plus(pkg))
                .setElement(2.0, 1, 1, accum=plus(pkg))
                .setElement(5.0, 0, 0, accum=plus(pkg)))

    def run_b(A, pkg):
        # overwrite (no accum) after an accum run must not fold across runs
        return (A.setElement(1.0, 1, 1, accum=plus(pkg))
                .setElement(99.0, 1, 1)
                .setElement(1.0, 1, 1, accum=plus(pkg)))

    def run_c(A, pkg):
        # last write wins within a no-accum run
        return A.setElement(2.0, 3, 3).setElement(4.0, 3, 3)

    for run, want in [(run_a, {(1, 1): 13.0, (0, 0): 5.0}),
                      (run_b, {(1, 1): 100.0}),
                      (run_c, {(1, 1): 10.0, (3, 3): 4.0})]:
        At, Aj = mk(kind, [1], [1], [10.0], 4, 4)
        Rt, Rj = both(run, At, Aj)
        same(Rt, Rj)
        assert tuples_of(Rt) == want


@pytest.mark.parametrize("kind", KINDS + ["bitmap"])
def test_ops_fold_pending_first(kind):
    """Any operation on a dirty container sees the folded state (the
    GB_WAIT-at-entry discipline)."""
    def mk3(I, J, X):
        if kind == "bitmap":
            X = np.asarray(X, np.int64)
            return (gt.Matrix.from_coo(I, J, X, 3, 3, type=gt.INT64,
                                       device="cpu"),
                    gb.Matrix.from_coo(I, J, X, 3, 3, type=gb.INT64))
        return mk(kind, I, J, np.asarray(X, np.int64), 3, 3, "INT64")
    At, Aj = mk3([0, 1], [1, 2], [1, 2])
    At = At.setElement(np.int64(5), 2, 0, blocking=False)
    Aj = Aj.setElement(np.int64(5), 2, 0, blocking=False)
    Bt, Bj = mk3([2], [0], [7])
    Ct, Cj = mk3([], [], [])
    got_t = gt.eWiseAdd(Ct, None, None, gt.binary.plus[gt.INT64], At, Bt)
    got_j = gb.eWiseAdd(Cj, None, None, gb.binary.plus[gb.INT64], Aj, Bj)
    assert tuples_of(got_t) == tuples_of(got_j) == \
        {(0, 1): 1, (1, 2): 2, (2, 0): 12}
    st = gt.reduce_to_scalar(None, gt.monoid.plus[gt.INT64], At)
    assert int(st) == int(gb.reduce_to_scalar(None, gb.monoid.plus[gb.INT64],
                                              Aj)) == 8
    # a pending entry reaches the products, the masks and the reduces
    u = gt.Vector.from_dense(np.ones(3, np.int64), gt.INT64, device="cpu")
    y = gt.mxv(gt.Vector.new(gt.INT64, 3, device="cpu"), None, None,
               gt.semiring.plus_times[gt.INT64], At, u)
    assert y.to_dense().tolist() == [1, 2, 5]
    w = gt.reduce_to_vector(gt.Vector.new(gt.INT64, 3, device="cpu"), None,
                            None, gt.monoid.plus[gt.INT64], At)
    assert w.to_dense().tolist() == [1, 2, 5]


@pytest.mark.parametrize("kind", KINDS)
def test_resize(kind):
    At, Aj = mk(kind, [0, 2, 4], [1, 3, 5], [1.0, 2.0, 3.0], 6, 6)
    St, Sj = At.resize(3, 4), Aj.resize(3, 4)  # prunes (4,5)
    assert (St.nrows, St.ncols) == (3, 4)
    same(St, Sj)
    assert tuples_of(St) == {(0, 1): 1.0, (2, 3): 2.0}
    Gt, Gj = At.resize(10, 12), Aj.resize(10, 12)  # grow: all survive
    assert (Gt.nrows, Gt.ncols) == (10, 12)
    same(Gt, Gj)
    # a grown frame takes entries in the new region; pending entries
    # fold before the resize
    Gt, Gj = Gt.setElement(4.0, 9, 11), Gj.setElement(4.0, 9, 11)
    assert Gt.extractElement(9, 11) == Gj.extractElement(9, 11) == 4.0
    same(Gt.resize(10, 11), Gj.resize(10, 11))
    assert Gt.clear().nvals == 0 and Gt.clear().shape == (10, 12)


def test_setelement_scale_100k():
    """A scale-style graph takes incremental updates without a full
    rebuild: n = 100K CSR, 200 buffered updates, one batched wait."""
    rng = np.random.default_rng(3)
    n, nnz = 100_000, 50_000
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    X = rng.integers(1, 100, nnz).astype(np.int64)
    At = gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.INT64, device="cpu")
    Aj = JCsr.from_coo(I, J, X, n, n, type=gb.INT64)
    want = tuples_of(Aj)
    upd = rng.integers(0, n, (200, 2))
    upd_x = rng.integers(1, 100, 200)
    Bt, Bj = At, Aj
    for (i, j), x in zip(upd, upd_x):
        Bt = Bt.setElement(np.int64(x), int(i), int(j))
        Bj = Bj.setElement(np.int64(x), int(i), int(j))
        want[(int(i), int(j))] = int(x)
    assert len(Bt._pending) == 200   # all buffered, no device work yet
    assert At.nvals == Aj.nvals and not At._pending   # inputs untouched
    Bt, Bj = Bt.wait(), Bj.wait()
    assert not Bt._pending
    same(Bt, Bj)
    assert tuples_of(Bt) == want
    i0, j0 = (int(v) for v in upd[0])
    assert Bt.extractElement(i0, j0) == want[(i0, j0)]


def test_setelement_hyper_2p40():
    """setElement / wait / extractElement / removeElement / resize at
    dimension 2^40, equal to the JAX package's."""
    dim = 1 << 40
    base = np.int64(3) << 30
    I = base + np.array([5, 9, 9], np.int64)
    J = base + np.array([7, 1, 4], np.int64)
    Ht, Hj = mk("hyper", I, J, np.array([1.0, 2.0, 3.0]), dim, dim)

    def step(H, pkg):
        return (H.setElement(8.0, int(base + 9), int(base + 1))  # overwrite
                .setElement(4.0, int(dim - 1), int(dim - 1)))    # far new
    Ht, Hj = both(step, Ht, Hj)
    for ij in [(base + 9, base + 1), (dim - 1, dim - 1), (base + 5, base + 1)]:
        ij = tuple(int(x) for x in ij)
        assert Ht.extractElement(*ij) == Hj.extractElement(*ij)
    assert Ht.extractElement(int(dim - 1), int(dim - 1)) == 4.0
    assert Ht.extractElement(int(base + 5), int(base + 1)) is None
    same(Ht, Hj)
    assert len(tuples_of(Ht)) == 4
    R = Ht.removeElement(int(dim - 1), int(dim - 1))
    same(R, Hj.removeElement(int(dim - 1), int(dim - 1)))
    assert len(tuples_of(R)) == 3
    S = Ht.resize(int(base + 10), int(base + 10))
    same(S, Hj.resize(int(base + 10), int(base + 10)))
    assert tuples_of(S) == {(int(base + 5), int(base + 7)): 1.0,
                            (int(base + 9), int(base + 1)): 8.0,
                            (int(base + 9), int(base + 4)): 3.0}


@pytest.mark.parametrize("kind", ["csr", "csc", "matrix", "vector"])
def test_from_jax_carries_pending(kind):
    """The pending tuples of a JAX container come across with it: the
    port's ``wait`` gives the JAX package's ``wait``."""
    rng = np.random.default_rng(11)
    plus = gb.binary.plus[gb.FP64]
    if kind == "vector":
        A = gb.Vector.from_dense(rng.normal(size=7), gb.FP64,
                                 pattern=rng.random(7) < 0.5)
        upd = [((3,), 1.5, None), ((3,), 2.0, plus), ((6,), -1.0, plus),
               ((0,), 4.0, None)]
    else:
        I = rng.integers(0, 5, 9)
        J = rng.integers(0, 6, 9)
        X = rng.normal(size=9)
        if kind == "matrix":
            A = gb.Matrix.from_coo(I, J, X, 5, 6, type=gb.FP64)
        else:
            A = (JCsr if kind == "csr" else JCsc).from_coo(
                I, J, X, 5, 6, type=gb.FP64)
        upd = [((int(I[0]), int(J[0])), 9.0, None),
               ((4, 5), 1.0, plus), ((4, 5), 2.0, plus), ((0, 0), 3.0, None),
               ((int(I[1]), int(J[1])), 0.5, plus)]
    for idx, x, acc in upd:
        A = A.setElement(x, *idx, accum=acc, blocking=False)
    At = from_jax(A, device="cpu")
    assert At.wait() is not At
    if kind == "vector":
        got, want = At.wait().extractTuples(), A.wait().extractTuples()
    else:
        got, want = At.extractTuples(), A.wait().extractTuples()
    for x, y in zip(got, want):
        assert np.array_equal(x, np.asarray(y))


TYPES = ["BOOL", "INT8", "UINT8", "INT32", "UINT32", "INT64", "UINT64",
         "FP32", "FP64"]


def _scalar(rng, tname):
    if tname == "BOOL":
        return bool(rng.random() < 0.5)
    if tname.startswith("FP"):
        return float(np.round(rng.normal() * 9, 2))
    lo = 0 if tname.startswith("U") else -9
    return int(rng.integers(lo, 100))


@pytest.mark.parametrize("tname", TYPES)
@pytest.mark.parametrize("vec", [False, True])
def test_bitmap_wait_matches_jax(tname, vec):
    """Runs of overwrites and of accums (with duplicates in and across
    runs, singletons and long runs) fold as the JAX package's
    ``Matrix.wait``; folding every tuple at once (blocking) gives the
    same pattern and values (FP64 sums within reassociation: the batch
    adds a run's duplicates before the old value)."""
    rng = np.random.default_rng(5)
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    shape = (6,) if vec else (4, 5)
    x = np.asarray([_scalar(rng, tname) for _ in range(int(np.prod(shape)))],
                   tt.dtype).reshape(shape)
    p = rng.random(shape) < 0.4
    cls_t = gt.Vector if vec else gt.Matrix
    cls_j = gb.Vector if vec else gb.Matrix
    At = cls_t.from_dense(x, tt, pattern=p, device="cpu")
    Aj = cls_j.from_dense(x, tj, pattern=p)
    accs = {"plus": "plus", "max": "max", "lor": "lor"}
    acc = "lor" if tname == "BOOL" else ("plus" if tname != "FP32"
                                         else "max")
    Bt, Bj, Ct = At, Aj, At
    for k in range(40):
        run = (k // 5) % 3      # runs of five: none, accum, none...
        op_t = None if run != 1 else gt.binary[accs[acc]][tt]
        op_j = None if run != 1 else gb.binary[accs[acc]][tj]
        idx = tuple(int(rng.integers(0, d)) for d in shape)
        s = _scalar(rng, tname)
        Bt = Bt.setElement(s, *idx, accum=op_t, blocking=False)
        Bj = Bj.setElement(s, *idx, accum=op_j, blocking=False)
        Ct = Ct.setElement(s, *idx, accum=op_t, blocking=True)
        if k == 0:
            # a run of one folds alone
            Bt, Bj = Bt.wait(), Bj.wait()
    assert len(Bt._pending) == 39 and not Ct._pending
    Wt, Wj = Bt.wait(), Bj.wait()
    assert np.array_equal(Wt.pattern_np(), np.asarray(Wj.pattern))
    assert np.array_equal(Wt.to_dense(), np.asarray(Wj.to_dense()))
    assert Wt.nvals() == Wj.nvals() == Bt.nvals()
    # folding one tuple at a time adds to the entry in turn, the batch
    # sums a run's duplicates first: equal but for float reassociation
    if tname == "FP64":
        assert np.allclose(Ct.to_dense(), Wt.to_dense(), rtol=1e-12,
                           atol=0)
    else:
        assert np.array_equal(Ct.to_dense(), Wt.to_dense())
    assert np.array_equal(Ct.pattern_np(), Wt.pattern_np())
    assert len(Bt._pending) == 39    # reading folds into a new container


def test_bitmap_element_access_waits():
    """extractElement, removeElement, extractTuples, resize, T and nvals
    see the pending tuples, as the JAX package's do."""
    t = gt.FP64
    C = gt.Matrix.new(t, 4, 4, device="cpu")
    C = C.setElement(1.5, 0, 0, blocking=False)
    C = C.setElement(2.5, 0, 0, accum=gt.binary.plus[t], blocking=False)
    C = C.setElement(7.0, 3, 2, blocking=False)
    assert len(C._pending) == 3
    assert C.extractElement(0, 0) == 4.0
    assert C.extractElement(3, 2) == 7.0
    assert C.extractElement(1, 1) is None
    assert C.nvals() == 2
    I, J, X = C.extractTuples()
    assert (I.tolist(), J.tolist(), X.tolist()) == ([0, 3], [0, 2],
                                                    [4.0, 7.0])
    assert C.T().extractElement(2, 3) == 7.0
    assert C.resize(2, 2).nvals() == 1
    D = C.removeElement(3, 2)
    assert D.nvals() == 1 and not D._pending
    assert C.dup()._pending == C._pending and not C.clear()._pending
    v = gt.Vector.new(gt.INT32, 5, device="cpu").setElement(3, 4)
    assert v.extractElement(4) == 3 and v.resize(3).nvals() == 0
    with pytest.raises(gt.IndexOutOfBounds):
        v.setElement(1, 5)
    with pytest.raises(TypeError):
        v.setElement(1, 0, accum="plus")


def test_blocking_mode_folds_at_once():
    """In blocking mode (``GrB_init(GrB_BLOCKING)``) setElement folds
    immediately on every container."""
    try:
        gt.init(gt.BLOCKING)
        gb.init(gb.BLOCKING)
        v = gt.Vector.new(gt.FP64, 3, device="cpu").setElement(2.0, 1)
        A, _ = mk("csr", [0], [0], [1.0], 2, 2)
        A = A.setElement(3.0, 1, 1)
        assert not v._pending and not A._pending
        assert v.extractElement(1) == 2.0 and A.extractElement(1, 1) == 3.0
    finally:
        gt.init(gt.NONBLOCKING)
        gb.init(gb.NONBLOCKING)
    v = gt.Vector.new(gt.FP64, 3, device="cpu").setElement(2.0, 1)
    assert v._pending


def test_hypersparse_pending_raises():
    """The hypersparse fold runs over a user-defined type too (the JAX
    package raises there): struct tuples fold with their accum and land
    as they do on CSR; an accum whose types are not the port's still
    raises when the tuple is added."""
    P = gt.Type.udt("UDT", x=gt.FP64, n=gt.INT32)
    add = gt.BinaryOp("PADD", lambda a, b: {"x": a["x"] + b["x"],
                                            "n": a["n"] + b["n"]}, P, P, P)
    X = {"x": np.array([1.0]), "n": np.array([2], np.int32)}
    H = gt.hyper_from_coo([1], [2], X, 4, 4, type=P, device="cpu")
    C = gt.CsrMatrix.from_coo([1], [2], X, 4, 4, type=P, device="cpu")
    for op in ((3.0, 0), (4.0, 1), (5.0, 1)):
        v = {"x": op[0], "n": op[1]}
        H = H.setElement(v, 1, 2, accum=add).setElement(v, 0, 0)
        C = C.setElement(v, 1, 2, accum=add).setElement(v, 0, 0)
    Ih, Jh, Xh = tpending.fold_pending_hyper(H).extractTuples()
    Ic, Jc, Xc = C.wait().extractTuples()
    assert np.array_equal(Ih, Ic) and np.array_equal(Jh, Jc)
    assert np.array_equal(Xh["x"], Xc["x"]) and np.array_equal(Xh["n"],
                                                               Xc["n"])
    assert Xh["x"].tolist() == [5.0, 13.0] and Xh["n"].tolist() == [1, 4]
    with pytest.raises(TypeError):
        H.setElement(1.0, 0, 0, accum="PLUS")


def test_degrees_and_csc_views():
    rng = np.random.default_rng(2)
    I = rng.integers(0, 9, 30)
    J = rng.integers(0, 5, 30)
    X = rng.normal(size=30)
    At, Aj = mk("csr", I, J, X, 9, 5)
    assert np.array_equal(At.row_degrees().numpy(),
                          np.asarray(Aj.row_degrees()))
    Ct, Cj = mk("csc", I, J, X, 9, 5)
    assert np.array_equal(Ct.col_degrees().numpy(),
                          np.asarray(Cj.col_degrees()))
    for a, b in ((Ct.colptr, Cj.colptr), (Ct.rowidx, Cj.rowidx),
                 (Ct.values, Cj.values)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # metadata, CSR <-> CSC round trips (tests/test_csc.py)
    assert Ct.shape == (9, 5) and (Ct.nrows, Ct.ncols) == (9, 5)
    same(Ct.to_csr(), Cj.to_csr())
    same(gt.CscMatrix.from_csr(Ct.to_csr()), Cj)
    assert np.array_equal(Ct.to_matrix().to_dense(),
                          np.asarray(Cj.to_matrix().to_dense()))


@pytest.mark.parametrize("tname", ["BOOL", "INT8", "UINT32", "UINT64",
                                   "FP32"])
def test_extract_element_types(tname):
    """extractElement returns a numpy scalar of the type (an unsigned
    value read back from its signed storage)."""
    tt, tj = getattr(gt, tname), getattr(gb, tname)
    X = np.asarray([1, 200, 7], np.uint64).astype(tt.dtype)
    if tname == "UINT64":
        X[1] = np.uint64(2 ** 64 - 3)
    At = gt.CsrMatrix.from_coo([0, 1, 2], [2, 1, 0], X, 3, 3, type=tt,
                               device="cpu")
    Aj = JCsr.from_coo([0, 1, 2], [2, 1, 0], X, 3, 3, type=tj)
    for ij in [(0, 2), (1, 1), (2, 0), (0, 0)]:
        a, b = At.extractElement(*ij), Aj.extractElement(*ij)
        assert (a is None and b is None) or (a == b and
                                             a.dtype == np.dtype(tj.dtype))
