"""PyTorch port, LOR/LAND folds over non-bool types: one rule on every
engine and container.

The reference defines ``LOR(x, y) = (x != 0) || (y != 0)`` and
``LAND(x, y) = (x != 0) && (y != 0)``, values 0 and 1 in the type.  The
port folds both monoids by the op from the identity on every engine
(``segment_reduce`` for the CSR row reduce, CSR SpMV and ESC;
``Monoid.reduce`` for the bitmap and scalar reduces): 1 where any
(LOR) or every (LAND) term is nonzero, 0 otherwise.  Each test asserts
that rule on CSR, CSC and bitmap.  The JAX package folds these monoids
by a max/min of the values, and its CSR and bitmap engines disagree
with each other; the first tests record its values as the reference's
(ROADMAP.md queue 3, "known in the reference").
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.sparse.container import CscMatrix as JCsc
from graphblas_tpu.sparse.container import CsrMatrix as JCsr
import graphblas_tpu_torch as gt

CPU = "cpu"
KINDS = ["csr", "csc", "bitmap"]
TYPES = ["INT8", "UINT8", "UINT32"]


def port(kind, I, J, X, m, n, tname):
    t = getattr(gt, tname)
    if kind == "csr":
        return gt.CsrMatrix.from_coo(I, J, X, m, n, type=t,
                                     sum_duplicates=False, device=CPU)
    if kind == "csc":
        return gt.CscMatrix.from_coo(I, J, X, m, n, type=t,
                                     sum_duplicates=False, device=CPU)
    return gt.Matrix.from_coo(I, J, X, m, n, type=t, device=CPU)


def jax_of(kind, I, J, X, m, n, tname):
    t = getattr(gb, tname)
    if kind == "csr":
        return JCsr.from_coo(I, J, X, m, n, type=t, sum_duplicates=False)
    if kind == "csc":
        return JCsc.from_coo(I, J, X, m, n, type=t, sum_duplicates=False)
    return gb.Matrix.from_coo(I, J, X, m, n, type=t)


def row_reduce(pkg, A, mon, tname):
    t = getattr(pkg, tname)
    kw = {"device": CPU} if pkg is gt else {}
    w = pkg.reduce_to_vector(pkg.Vector.new(t, A.shape[0], **kw), None,
                             None, pkg.monoid[mon][t], A)
    return np.asarray(w.to_dense()).tolist(), \
        np.asarray(w.pattern_np() if pkg is gt else w.pattern).tolist()


# -- the inputs of ROADMAP.md queue 3, the JAX values recorded ---------------

@pytest.mark.parametrize("kind", KINDS)
def test_reduce_to_vector_recorded_inputs(kind):
    cases = [  # (row 0 values, columns, type, monoid, port, JAX by kind)
        ([-1, -2], [0, 1], "INT8", "lor", 1, {"csr": -1, "csc": -1,
                                               "bitmap": -1}),
        ([-1], [0], "INT8", "lor", 1, {"csr": -1, "csc": -1,
                                       "bitmap": 0}),
        ([2, 3], [0, 1], "UINT8", "land", 1, {"csr": 2, "csc": 2,
                                              "bitmap": 2}),
    ]
    for vals, cols, tname, mon, want, jax_want in cases:
        X = np.array(vals, np.dtype(getattr(gb, tname).dtype))
        I = np.zeros(len(cols), np.int64)
        vt, pt = row_reduce(gt, port(kind, I, cols, X, 2, 2, tname), mon,
                            tname)
        assert vt[0] == want and pt == [True, False]
        vj, _ = row_reduce(gb, jax_of(kind, I, cols, X, 2, 2, tname), mon,
                           tname)
        assert vj[0] == jax_want[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_reduce_to_scalar_recorded_inputs(kind):
    for vals, tname, mon, jax_want in (([5, 255], "UINT8", "lor", 255),
                                       ([1 << 31, 7], "UINT32", "land", 1)):
        X = np.array(vals, np.dtype(getattr(gb, tname).dtype))
        I, J = [0, 0], [0, 1]
        st = gt.reduce_to_scalar(None, gt.monoid[mon][getattr(gt, tname)],
                                 port(kind, I, J, X, 2, 2, tname))
        sj = gb.reduce_to_scalar(None, gb.monoid[mon][getattr(gb, tname)],
                                 jax_of(kind, I, J, X, 2, 2, tname))
        assert st == 1 and st.dtype == X.dtype
        assert int(sj) == jax_want


@pytest.mark.parametrize("kind", KINDS)
def test_mxv_lor_first_recorded_input(kind):
    X = np.array([-1, -2], np.int8)
    I, J = [0, 0], [0, 1]
    wt = gt.mxv(gt.Vector.new(gt.INT8, 2, device=CPU), None, None,
                gt.semiring.lor_first[gt.INT8],
                port(kind, I, J, X, 2, 2, "INT8"),
                gt.Vector.from_dense(np.ones(2, np.int8), gt.INT8,
                                     device=CPU))
    wj = gb.mxv(gb.Vector.new(gb.INT8, 2), None, None,
                gb.semiring.lor_first[gb.INT8],
                jax_of(kind, I, J, X, 2, 2, "INT8"),
                gb.Vector.from_dense(np.ones(2, np.int8), gb.INT8))
    assert wt.to_dense().tolist()[0] == 1
    assert int(np.asarray(wj.to_dense())[0]) == \
        {"csr": -1, "csc": -1, "bitmap": 1}[kind]


def test_bool_plus_times_row_reduce_pinned():
    """BOOL PLUS/TIMES row reduce: the port gives the bitmap answer on
    every container (LOR/LAND); the JAX CSR raises TypeError
    (``jax.ops.segment_sum`` rejects bool)."""
    I, J, X = [0, 0, 1], [0, 1, 0], np.array([True, False, False])
    for kind in KINDS:
        A = port(kind, I, J, X, 2, 2, "BOOL")
        for mon, want in (("plus", [True, False]), ("times", [False,
                                                              False])):
            assert row_reduce(gt, A, mon, "BOOL")[0] == want
            assert row_reduce(gb, jax_of("bitmap", I, J, X, 2, 2, "BOOL"),
                              mon, "BOOL")[0] == want
    with pytest.raises(TypeError):
        row_reduce(gb, jax_of("csr", I, J, X, 2, 2, "BOOL"), "plus", "BOOL")


# -- the rule on random inputs, every engine ---------------------------------

def _rand(rng, m, n, density, tname):
    p = rng.random((m, n)) < density
    I, J = np.nonzero(p)
    info = np.iinfo(np.dtype(getattr(gb, tname).dtype))
    X = rng.integers(info.min, int(info.max) + 1, len(I),
                     dtype=np.int64).astype(info.dtype)
    X[rng.random(len(I)) < 0.3] = 0      # explicit zeros
    return I, J, X


def _fold(mon, vals):
    nz = [v != 0 for v in vals]
    return int(any(nz)) if mon == "lor" else int(all(nz))


@pytest.mark.parametrize("tname", TYPES)
@pytest.mark.parametrize("mon", ["lor", "land"])
@pytest.mark.parametrize("kind", KINDS)
def test_reduces_follow_the_op(kind, mon, tname):
    rng = np.random.default_rng(17)
    m, n = 12, 9
    I, J, X = _rand(rng, m, n, 0.4, tname)
    A = port(kind, I, J, X, m, n, tname)
    vals, pat = row_reduce(gt, A, mon, tname)
    for i in range(m):
        row = X[I == i].tolist()
        assert pat[i] == bool(row)
        assert vals[i] == (_fold(mon, row) if row else 0)
    s = gt.reduce_to_scalar(None, gt.monoid[mon][getattr(gt, tname)], A)
    assert s == _fold(mon, X.tolist())


@pytest.mark.parametrize("tname", TYPES)
@pytest.mark.parametrize("name", ["lor_first", "land_first", "land_second",
                                  "lor_second"])
def test_mxv_and_esc_follow_the_op(name, tname):
    """CSR SpMV (dense-x and sparse-x), the bitmap product and ESC mxm
    give the op's fold: C[i, j] = (add over k) of (x != 0) of the mult's
    operand, on the pairs present."""
    rng = np.random.default_rng(23)
    n = 40
    tA, tB = _rand(rng, n, n, 0.15, tname), _rand(rng, n, n, 0.15, tname)
    dt = np.dtype(getattr(gb, tname).dtype)
    add, mult = name.split("_")
    Ad = {(i, j): x for i, j, x in zip(*tA)}
    Bd = {(i, j): x for i, j, x in zip(*tB)}
    want = {}
    for (i, k), a in Ad.items():
        for j in range(n):
            if (k, j) in Bd:
                want.setdefault((i, j), []).append(
                    a if mult == "first" else Bd[(k, j)])
    want = {ij: _fold(add, v) for ij, v in want.items()}
    sr = gt.semiring[name][getattr(gt, tname)]
    for kind in KINDS:
        A, B = port(kind, *tA, n, n, tname), port(kind, *tB, n, n, tname)
        C = gt.Matrix.new(getattr(gt, tname), n, n, device=CPU)
        got = gt.mxm(C, None, None, sr, A, B)
        I, J, X = got.extractTuples()
        assert dict(zip(zip(I.tolist(), J.tolist()), X.tolist())) == want
    Ac = port("csr", *tA, n, n, tname)
    Bc = port("csr", *tB, n, n, tname)
    E = gt.csr_spgemm(sr, Ac, Bc)
    assert gt.last_axb_method() == "esc:csr_spgemm"
    I, J, X = E.extractTuples()
    assert X.dtype == dt
    assert dict(zip(zip(I.tolist(), J.tolist()), X.tolist())) == want
    # SpMV: column 0 of B as u, both engines (all present / sparse)
    for u in (np.ones(n, dt), np.where(np.arange(n) % 3 == 0, 1, 0).astype(dt)):
        pat = np.ones(n, bool) if u.all() else u != 0
        ut = gt.Vector.from_dense(u, getattr(gt, tname), pattern=pat,
                                  device=CPU)
        for kind in KINDS:
            w = gt.mxv(gt.Vector.new(getattr(gt, tname), n, device=CPU),
                       None, None, sr, port(kind, *tA, n, n, tname), ut)
            for i in range(n):
                terms = [a if mult == "first" else u[k]
                         for (r, k), a in Ad.items() if r == i and pat[k]]
                assert w.pattern_np()[i] == bool(terms)
                if terms:
                    assert w.to_dense()[i] == _fold(add, terms), (kind, i)
