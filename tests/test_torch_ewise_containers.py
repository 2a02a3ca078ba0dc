"""PyTorch port, the op x container matrix: a mirror of
``tests/test_ewise_containers.py`` for the ``csr`` and ``csc`` kinds in
parity with the JAX package.

eWiseAdd / eWiseMult / apply / select / reduce / transpose / kron on
``CsrMatrix`` and ``CscMatrix`` with the whole mask / accum / REPLACE /
SCMP / transpose surface: the same numpy-seeded operands
(``tests.helpers.rand_om``) go through both packages, and the outputs'
tuples (row, column, value) must be equal exactly, floats included
(one IEEE operation per entry in both).  The reduces are integer and
exact.  The ``hyper`` kind (the port's ``HyperMatrix``) runs the same
matrix since the hypersparse slice, and ``test_ewise_hyper_2p40``
mirrors the JAX test of the same name."""

import collections

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
from graphblas_tpu.sparse.hyper import HyperMatrix
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.convert import from_jax
from graphblas_tpu_torch.sparse.ewise import csr_ewise_add

from . import oracle as orc
from .helpers import rand_om
from .test_ewise_containers import om_to


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU products: one intra-op thread a process keeps
    parallel test workers from oversubscribing the cores (the results
    do not depend on it); the setting is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KINDS = ["csr", "csc", "hyper"]


def om_to_gt(kind, o: orc.OM, tname: str):
    t = getattr(gt, tname)
    I, J = np.nonzero(o.p)
    X = o.m[I, J]
    m, n = o.p.shape
    if kind == "csr":
        return gt.CsrMatrix.from_coo(I, J, X, m, n, type=t,
                                     sum_duplicates=False, device="cpu")
    if kind == "csc":
        return gt.CscMatrix.from_coo(I, J, X, m, n, type=t,
                                     sum_duplicates=False, device="cpu")
    if kind == "hyper":
        return gt.HyperMatrix.from_coo(I, J, X, m, n, type=t, dup=None,
                                       device="cpu")
    if kind == "bitmap":
        return gt.Matrix.from_dense(o.m, type=t, pattern=o.p, device="cpu")
    raise ValueError(kind)


def both(kind, o, tname):
    """(port container, JAX container) of the same operand."""
    return om_to_gt(kind, o, tname), om_to(kind, o, getattr(gb, tname))


def tuples(X):
    """The entries as a dict (i, j) -> value (host, the type's dtype)."""
    I, J, V = X.extractTuples()
    return {(int(i), int(j)): v for i, j, v in zip(I, J, np.asarray(V))}


def assert_same_tuples(got, want, kind=None):
    if kind == "csc":
        assert isinstance(got, gt.CscMatrix)
    elif kind == "csr":
        assert isinstance(got, gt.CsrMatrix)
    elif kind == "hyper":
        assert isinstance(got, gt.HyperMatrix)
    assert got.shape == want.shape
    g, w = tuples(got), tuples(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = g[k], w[k]
        assert a == b or (np.isnan(a) and np.isnan(b)), (k, a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("union", [True, False])
def test_ewise_container_epilogue_sweep(rng, kind, union):
    for accum in (None, "plus"):
        for has_mask in (False, True):
            for scmp in (False, True):
                for replace in (False, True):
                    A = rand_om(rng, (7, 6), np.int32, 0.5)
                    B = rand_om(rng, (7, 6), np.int32, 0.5)
                    C = rand_om(rng, (7, 6), np.int32, 0.4)
                    M = rand_om(rng, (7, 6), np.bool_, 0.5) \
                        if has_mask else None
                    (At, Aj), (Bt, Bj), (Ct, Cj) = (
                        both(kind, X, "INT32") for X in (A, B, C))
                    Mt, Mj = both(kind, M, "BOOL") if M else (None, None)
                    fj = gb.eWiseAdd if union else gb.eWiseMult
                    ft = gt.eWiseAdd if union else gt.eWiseMult
                    want = fj(Cj, Mj, gb.binary.plus[gb.INT32]
                              if accum else None, gb.binary.max[gb.INT32],
                              Aj, Bj, gb.Descriptor(replace=replace,
                                                    mask_scmp=scmp))
                    got = ft(Ct, Mt, gt.binary.plus[gt.INT32]
                             if accum else None, gt.binary.max[gt.INT32],
                             At, Bt, gt.Descriptor(replace=replace,
                                                   mask_scmp=scmp))
                    assert_same_tuples(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_ewise_container_transpose_inputs(rng, kind):
    A = rand_om(rng, (6, 7), np.float64, 0.5)   # A' is 7x6
    B = rand_om(rng, (7, 6), np.float64, 0.5)
    C = rand_om(rng, (7, 6), np.float64, 0.3)
    (At, Aj), (Bt, Bj), (Ct, Cj) = (both(kind, X, "FP64")
                                     for X in (A, B, C))
    want = gb.eWiseAdd(Cj, None, None, gb.binary.plus[gb.FP64], Aj, Bj,
                       gb.Descriptor(tran0=True))
    got = gt.eWiseAdd(Ct, None, None, gt.binary.plus[gt.FP64], At, Bt,
                      gt.Descriptor(tran0=True))
    assert_same_tuples(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_ewise_container_typecast(rng, kind):
    """Mixed stored types: op domains take precedence, singles cast
    straight to ztype (GB_add.c typecast rules)."""
    A = rand_om(rng, (5, 5), np.int8, 0.5)
    B = rand_om(rng, (5, 5), np.float64, 0.5)
    C = rand_om(rng, (5, 5), np.float64, 0.0)
    (At, Aj), (Bt, Bj), (Ct, Cj) = (both(kind, A, "INT8"),
                                     both(kind, B, "FP64"),
                                     both(kind, C, "FP64"))
    want = gb.eWiseAdd(Cj, None, None, gb.binary.plus[gb.FP64], Aj, Bj)
    got = gt.eWiseAdd(Ct, None, None, gt.binary.plus[gt.FP64], At, Bt)
    assert_same_tuples(got, want, kind)
    # eWiseAdd(minus): B-only entries keep b, the pairs take a - b
    want = gb.eWiseAdd(Cj, None, None, gb.binary.minus[gb.FP64], Aj, Bj)
    got = gt.eWiseAdd(Ct, None, None, gt.binary.minus[gt.FP64], At, Bt)
    assert_same_tuples(got, want, kind)
    bonly = B.p & ~A.p
    g = tuples(got)
    assert all(g[(int(i), int(j))] == B.m[i, j]
               for i, j in zip(*np.nonzero(bonly)))


def test_ewise_mixed_containers(rng):
    """Operands in a different container than C convert toward C."""
    A = rand_om(rng, (5, 4), np.int64, 0.6)
    B = rand_om(rng, (5, 4), np.int64, 0.6)
    C = rand_om(rng, (5, 4), np.int64, 0.0)
    want = orc.o_ewise("plus", np.int64, A, B, True)
    wantd = {(int(i), int(j)): want.m[i, j]
             for i, j in zip(*np.nonzero(want.p))}
    for ck in KINDS:
        for ak in ["csr", "csc", "bitmap"]:
            got = gt.eWiseAdd(om_to_gt(ck, C, "INT64"), None, None,
                              gt.binary.plus[gt.INT64],
                              om_to_gt(ak, A, "INT64"),
                              om_to_gt("csr", B, "INT64"))
            assert tuples(got) == wantd, (ck, ak)


@pytest.mark.parametrize("kind", KINDS)
def test_apply_container_mask_accum(rng, kind):
    A = rand_om(rng, (6, 5), np.float64, 0.6)
    C = rand_om(rng, (6, 5), np.float64, 0.4)
    M = rand_om(rng, (6, 5), np.bool_, 0.5)
    (At, Aj), (Ct, Cj) = both(kind, A, "FP64"), both(kind, C, "FP64")
    Mt, Mj = both(kind, M, "BOOL")
    want = gb.apply(Cj, Mj, gb.binary.plus[gb.FP64], gb.unary.ainv[gb.FP64],
                    Aj, gb.REPLACE)
    got = gt.apply(Ct, Mt, gt.binary.plus[gt.FP64], gt.unary.ainv[gt.FP64],
                   At, gt.REPLACE)
    assert_same_tuples(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("selname,k", [("tril", 0), ("triu", 1),
                                       ("diag", 0), ("offdiag", -1),
                                       ("nonzero", 0)])
def test_select_container(rng, kind, selname, k):
    A = rand_om(rng, (6, 6), np.float64, 0.7)
    C = rand_om(rng, (6, 6), np.float64, 0.0)
    (At, Aj), (Ct, Cj) = both(kind, A, "FP64"), both(kind, C, "FP64")
    want = gb.select(Cj, None, None, gb.selectop[selname], Aj, k)
    got = gt.select(Ct, None, None, gt.selectop[selname], At, k)
    assert_same_tuples(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_transpose_container_accum(rng, kind):
    A = rand_om(rng, (4, 6), np.float64, 0.5)
    C = rand_om(rng, (6, 4), np.float64, 0.5)
    (At, Aj), (Ct, Cj) = both(kind, A, "FP64"), both(kind, C, "FP64")
    want = gb.transpose(Cj, None, gb.binary.plus[gb.FP64], Aj)
    got = gt.transpose(Ct, None, gt.binary.plus[gt.FP64], At)
    assert_same_tuples(got, want, kind)
    # with a unary op fused, and INP0=TRAN (the double transpose)
    Ct, Cj = both(kind, rand_om(rng, (4, 6), np.float64, 0.5), "FP64")
    want = gb.transpose(Cj, None, None, Aj, gb.TRAN0,
                        op=gb.unary.abs[gb.FP64])
    got = gt.transpose(Ct, None, None, At, gt.TRAN0,
                       op=gt.unary.abs[gt.FP64])
    assert_same_tuples(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_kron_container(rng, kind):
    A = rand_om(rng, (2, 3), np.float64, 0.7)
    B = rand_om(rng, (3, 2), np.float64, 0.7)
    C = orc.OM(np.zeros((6, 6)), np.zeros((6, 6), bool))
    (At, Aj), (Bt, Bj), (Ct, Cj) = (both(kind, X, "FP64")
                                     for X in (A, B, C))
    want = gb.kron(Cj, None, None, gb.binary.times[gb.FP64], Aj, Bj)
    got = gt.kron(Ct, None, None, gt.binary.times[gt.FP64], At, Bt)
    assert_same_tuples(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mon", ["plus", "min", "max"])
def test_reduce_vector_container(rng, kind, mon):
    A = rand_om(rng, (7, 5), np.int64, 0.5)
    w = rand_om(rng, (7,), np.int64, 0.4)
    At, Aj = both(kind, A, "INT64")
    want = gb.reduce_to_vector(
        gb.Vector.from_dense(w.m, type=gb.INT64, pattern=w.p), None,
        gb.binary.plus[gb.INT64], gb.monoid[mon][gb.INT64], Aj)
    got = gt.reduce_to_vector(
        gt.Vector.from_dense(w.m, type=gt.INT64, pattern=w.p, device="cpu"),
        None, gt.binary.plus[gt.INT64], gt.monoid[mon][gt.INT64], At)
    wp = np.asarray(want.pattern)
    assert np.array_equal(got.pattern_np(), wp)
    assert np.array_equal(got.to_dense(), np.where(wp, want.values, 0))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mon", ["plus", "min", "max", "times"])
def test_reduce_scalar_container(rng, kind, mon):
    A = rand_om(rng, (6, 6), np.int64, 0.5)
    At, Aj = both(kind, A, "INT64")
    want = gb.reduce_to_scalar(None, gb.monoid[mon][gb.INT64], Aj)
    got = gt.reduce_to_scalar(None, gt.monoid[mon][gt.INT64], At)
    assert got == want == orc.o_reduce_scalar(mon, np.int64, A)
    assert np.asarray(got).dtype == np.int64


def test_ewise_csr_scale_100k(rng):
    """eWiseAdd with mask + accum + REPLACE at n = 100K on CSR, against
    the JAX package and a tuple-level oracle (no densification)."""
    n = 100_000
    nnz = 60_000
    IA, JA = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    XA = rng.integers(1, 100, nnz).astype(np.int64)
    IB, JB = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    XB = rng.integers(1, 100, nnz).astype(np.int64)
    ones = np.ones(100, np.int64)
    mones = np.ones(len(IA[::2]), np.int64)
    args = ((IA, JA, XA), (IB, JB, XB), (IA[:100], JB[:100], ones),
            (IA[::2], JA[::2], mones))
    At, Bt, Ct, Mt = (gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.INT64,
                                            device="cpu")
                      for I, J, X in args)
    Aj, Bj, Cj, Mj = (JCsr.from_coo(I, J, X, n, n, type=gb.INT64)
                      for I, J, X in args)
    got = gt.eWiseAdd(Ct, Mt, gt.binary.plus[gt.INT64],
                      gt.binary.plus[gt.INT64], At, Bt,
                      gt.Descriptor(replace=True))
    want = gb.eWiseAdd(Cj, Mj, gb.binary.plus[gb.INT64],
                       gb.binary.plus[gb.INT64], Aj, Bj,
                       gb.Descriptor(replace=True))
    assert_same_tuples(got, want, "csr")
    am = collections.defaultdict(int)
    for X in (At, Bt):
        for k_, x in tuples(X).items():
            am[k_] += int(x)
    cm = {k_: int(x) for k_, x in tuples(Ct).items()}
    mset = set(tuples(Mt))
    oracle = {k_: tv + cm.get(k_, 0) for k_, tv in am.items() if k_ in mset}
    oracle.update({k_: cv for k_, cv in cm.items()
                   if k_ in mset and k_ not in am})
    assert {k_: int(x) for k_, x in tuples(got).items()} == oracle
    # the union engine's capacity is its exact count (at least 8 lanes)
    U = csr_ewise_add(gt.binary.plus[gt.INT64], At, Bt)
    assert U.nzmax == U.nvals == len(am)


def test_ewise_hyper_2p40():
    """eWiseAdd/Mult, apply, select and reduce at dimension 2^40 on the
    hypersparse container, equal to the JAX package's."""
    rng = np.random.default_rng(44)
    dim = 1 << 40
    base = np.int64(7) * (1 << 30)
    n = 3000
    tup = [(base + rng.integers(0, 1 << 20, n).astype(np.int64),
            base + rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(1, 50, n).astype(np.int64)) for _ in range(2)]
    e = np.zeros(0, np.int64)
    outs = []
    for pkg in (gt, gb):
        kw = {"device": "cpu"} if pkg is gt else {}
        H = gt.HyperMatrix if pkg is gt else HyperMatrix
        A, B = (H.from_coo(*t_, dim, dim, type=pkg.INT64, **kw)
                for t_ in tup)
        C = H.from_coo(e, e, e, dim, dim, type=pkg.INT64, **kw)
        outs.append([
            pkg.eWiseAdd(C, None, None, pkg.binary.plus[pkg.INT64], A, B),
            pkg.eWiseMult(C, None, None, pkg.binary.times[pkg.INT64], A, B),
            pkg.apply(C, None, None, pkg.unary.ainv[pkg.INT64], A),
            pkg.select(C, None, None, pkg.selectop.tril, A, 0),
            int(pkg.reduce_to_scalar(None, pkg.monoid.plus[pkg.INT64], A))])
    for x, y in zip(outs[0][:-1], outs[1][:-1]):
        assert isinstance(x, gt.HyperMatrix)
        assert_same_tuples(x, y)
    am = collections.defaultdict(int)
    for t_ in tup:
        for i, j, x in zip(*t_):
            am[(int(i), int(j))] += int(x)
    assert tuples(outs[0][0]) == dict(am)
    assert outs[0][-1] == outs[1][-1] == int(tup[0][2].sum())


def test_hypersparse_raises_typed():
    """A JAX package HyperMatrix is not a container of the port: every
    new op raises UnsupportedContainer and densifies nothing.  The
    port's own HyperMatrix (``from_jax``) runs the same calls, equal to
    the JAX package's."""
    dim = 1 << 40
    H = HyperMatrix.from_coo(np.array([5], np.int64),
                             np.array([7], np.int64), np.array([1.0]),
                             dim, dim, type=gb.FP64)
    C = gt.CsrMatrix.from_coo([0], [1], [1.0], 4, 4, type=gt.FP64,
                              device="cpu")
    w = gt.Vector.new(gt.FP64, 4, device="cpu")
    calls = [
        lambda: gt.eWiseAdd(C, None, None, "plus", H, C),
        lambda: gt.eWiseMult(H, None, None, "times", C, C),
        lambda: gt.apply(C, None, None, "ainv", H),
        lambda: gt.select(C, None, None, "tril", H, 0),
        lambda: gt.reduce_to_vector(w, None, None, "plus", H),
        lambda: gt.reduce_to_scalar(None, gt.monoid.plus[gt.FP64], H),
        lambda: gt.transpose(H, None, None, C),
        lambda: gt.kron(C, None, None, "times", C, H),
    ]
    for call in calls:
        with pytest.raises(gt.UnsupportedContainer, match="got HyperMatrix"
                           "|got CsrMatrix|expected a GraphBLAS container"):
            call()
    Ht = from_jax(H, device="cpu")
    for pkg, X in ((gt, Ht), (gb, H)):
        out = [pkg.eWiseAdd(X, None, None, pkg.binary.plus[pkg.FP64], X, X),
               pkg.apply(X, None, None, pkg.unary.ainv[pkg.FP64], X),
               pkg.select(X, None, None, pkg.selectop.tril, X, 0),
               pkg.transpose(X, None, None, X),
               pkg.reduce_to_scalar(None, pkg.monoid.plus[pkg.FP64], X)]
        if pkg is gt:
            got = out
    for x, y in zip(got[:-1], out[:-1]):
        for a, b in zip(x.extractTuples(), y.extractTuples()):
            assert np.array_equal(a, np.asarray(b))
    assert got[-1] == out[-1] == 1.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("opname", ["first", "second", "any"])
def test_kron_first_second_any_pinned(kind, opname):
    """A reference defect, not copied: the JAX ``kron`` with FIRST,
    SECOND or ANY into a CSR, CSC or hypersparse C raises ``IndexError``
    (``ops/transpose.py`` forms ``op(xa[:, None], xb[None, :])``, and
    these ops return one operand unbroadcast, so Z holds nnzA or nnzB
    values for nnzA * nnzB pairs).  The port gives the JAX bitmap
    ``kron``'s 9 entries."""
    A = orc.OM(np.array([[1., 2.], [3., 0.]]),
               np.array([[True, True], [True, False]]))
    B = orc.OM(np.array([[5., 6., 7.]]), np.ones((1, 3), bool))
    C = orc.OM(np.zeros((2, 6)), np.zeros((2, 6), bool))
    (At, Aj), (Bt, Bj) = both("bitmap", A, "FP64"), both("bitmap", B, "FP64")
    Ct, Cj = both(kind, C, "FP64")
    with pytest.raises(IndexError):
        gb.kron(Cj, None, None, getattr(gb.binary, opname)[gb.FP64], Aj, Bj)
    want = gb.kron(om_to("bitmap", C, gb.FP64), None, None,
                   getattr(gb.binary, opname)[gb.FP64], Aj, Bj)
    got = gt.kron(Ct, None, None, getattr(gt.binary, opname)[gt.FP64], At, Bt)
    assert len(tuples(want)) == 9
    assert_same_tuples(got, want, kind)
