"""PyTorch port, a user-defined struct type through every operation on
every container: CSR, CSC, bitmap and hypersparse.

The struct is {x: FP64, n: INT64}; its ops use only ``+`` and ``*``, so
one definition serves both packages.  The reference is the JAX
package's bitmap container on the same seeded inputs (the JAX package
refuses struct values on its hypersparse container, which the port
runs).  Patterns and the INT64 field are exact; the FP64 field agrees
within rtol 1e-12.  ``mxm`` runs twice per container: as the cost model
picks (the bitmap product at these sizes) and forced onto ESC
(``axb_method="gustavson"``), masked and unmasked.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.core.types import Type as JType
import graphblas_tpu_torch as gt

CPU = "cpu"
KINDS = ["csr", "csc", "bitmap", "hyper"]
N = 14
JP = JType.udt("xn", x=gb.FP64, n=gb.INT64)
TP = gt.Type.udt("xn", x=gt.FP64, n=gt.INT64)


def _ops(pkg, t):
    add = pkg.BinaryOp("XADD", lambda a, b: {"x": a["x"] + b["x"],
                                             "n": a["n"] + b["n"]}, t, t, t)
    mult = pkg.BinaryOp("XMUL", lambda a, b: {"x": a["x"] * b["x"],
                                              "n": a["n"] * b["n"]},
                        t, t, t)
    mon = (pkg.monoid_new if pkg is gt else
           gb.core.monoids.monoid_new)(add, {"x": 0.0, "n": 0})
    sr = (gt.semiring_new if pkg is gt else
          gb.core.semirings.semiring_new)(mon, mult)
    return add, mult, mon, sr


JADD, JMUL, JMON, JSR = _ops(gb, JP)
TADD, TMUL, TMON, TSR = _ops(gt, TP)


def _data(seed, m=N, n=N, nnz=50):
    rng = np.random.default_rng(seed)
    lin = np.unique(rng.integers(0, m * n, nnz))
    I, J = lin // n, lin % n
    X = {"x": rng.normal(size=len(I)),
         "n": rng.integers(1, 4, len(I)).astype(np.int64)}
    return I, J, X


def _dense(I, J, X, m, n):
    pat = np.zeros((m, n), bool)
    pat[I, J] = True
    vals = {}
    for f, v in X.items():
        d = np.zeros((m, n), v.dtype)
        d[I, J] = v
        vals[f] = d
    return vals, pat


def jmat(I, J, X, m=N, n=N):
    vals, pat = _dense(I, J, X, m, n)
    return gb.Matrix.from_dense(vals, JP, pattern=pat)


def tmat(kind, I, J, X, m=N, n=N):
    if kind == "csr":
        return gt.CsrMatrix.from_coo(I, J, X, m, n, type=TP, device=CPU)
    if kind == "csc":
        return gt.CscMatrix.from_coo(I, J, X, m, n, type=TP, device=CPU)
    if kind == "hyper":
        return gt.hyper_from_coo(I, J, X, m, n, type=TP, device=CPU)
    return gt.CsrMatrix.from_coo(I, J, X, m, n, type=TP,
                                 device=CPU).to_matrix()


def tempty(kind, m=N, n=N):
    E = {"x": np.zeros(0), "n": np.zeros(0, np.int64)}
    return tmat(kind, np.zeros(0, np.int64), np.zeros(0, np.int64), E, m, n)


def port_dense(C):
    """(values dict, pattern) of any port matrix container."""
    if isinstance(C, gt.HyperCscMatrix):
        C = C.to_hyper()
    if isinstance(C, gt.HyperMatrix):
        C = C.to_csr()
    if isinstance(C, (gt.CsrMatrix, gt.CscMatrix)):
        C = C.to_matrix()
    return C.to_dense(), C.pattern_np()


def assert_same(got, want_mat):
    gv, gp = got
    wv = {f: np.asarray(v) for f, v in want_mat.to_dense().items()}
    wp = np.asarray(want_mat.pattern)
    assert np.array_equal(gp, wp)
    np.testing.assert_allclose(gv["x"][wp], wv["x"][wp], rtol=1e-12)
    assert np.array_equal(gv["n"][wp], wv["n"][wp])


def _vec(seed, n=N):
    rng = np.random.default_rng(seed)
    x = {"x": rng.normal(size=n), "n": rng.integers(1, 4, n)}
    pat = rng.random(n) < 0.7
    return x, pat


def jvec(x, pat):
    import jax.numpy as jnp
    return gb.Vector({k: jnp.asarray(np.where(pat, v, 0)) for k, v in
                      x.items()}, jnp.asarray(pat), JP)


def tvec(kind, x, pat):
    v = gt.Vector.from_dense(x, TP, pattern=pat, device=CPU)
    return gt.SparseVec.from_vector(v) if kind == "hyper" else v


def vec_dense(w):
    if isinstance(w, gt.SparseVec):
        w = w.to_vector()
    return w.to_dense(), w.pattern_np()


def assert_same_vec(got, want):
    gv, gp = got
    wp = np.asarray(want.pattern)
    wv = want.to_dense()
    assert np.array_equal(gp, wp)
    np.testing.assert_allclose(gv["x"][wp], np.asarray(wv["x"])[wp],
                               rtol=1e-12)
    assert np.array_equal(gv["n"][wp], np.asarray(wv["n"])[wp])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("engine", [None, "gustavson"])
def test_udt_mxm(kind, masked, engine):
    I, J, X = _data(1)
    I2, J2, X2 = _data(2)
    Im, Jm, Xm = _data(3, nnz=80)
    d_j = gb.Descriptor(mask_structure=True, axb_method=engine)
    d_t = gt.Descriptor(mask_structure=True, axb_method=engine)
    want = gb.mxm(gb.Matrix.new(JP, N, N), jmat(Im, Jm, Xm) if masked
                  else None, None, JSR, jmat(I, J, X), jmat(I2, J2, X2),
                  d_j)
    # a CscMatrix is no mxm output (as in the JAX package): its case
    # runs CSC inputs into a CsrMatrix
    got = gt.mxm(tempty("csr" if kind == "csc" else kind),
                 tmat(kind, Im, Jm, Xm) if masked else None,
                 None, TSR, tmat(kind, I, J, X), tmat(kind, I2, J2, X2),
                 d_t)
    assert_same(port_dense(got), want)
    if kind == "csr" and engine == "gustavson":
        assert gt.last_axb_method() == "esc:csr_spgemm"


@pytest.mark.parametrize("kind", ["csr", "bitmap", "hyper"])
@pytest.mark.parametrize("op", ["mxv", "vxm"])
def test_udt_mxv_vxm(kind, op):
    I, J, X = _data(4)
    x, pat = _vec(5)
    Aj, At = jmat(I, J, X), tmat(kind, I, J, X)
    if op == "mxv":
        want = gb.mxv(gb.Vector.new(JP, N), None, None, JSR, Aj,
                      jvec(x, pat))
        w0 = tvec(kind, *_vec(99)) if kind == "hyper" else \
            gt.Vector.new(TP, N, device=CPU)
        if kind == "hyper":
            w0 = w0.clear()
        got = gt.mxv(w0, None, None, TSR, At, tvec(kind, x, pat))
    else:
        want = gb.vxm(gb.Vector.new(JP, N), None, None, JSR,
                      jvec(x, pat), Aj)
        w0 = gt.Vector.new(TP, N, device=CPU)
        if kind == "hyper":
            w0 = gt.SparseVec.from_vector(w0)
        got = gt.vxm(w0, None, None, TSR, tvec(kind, x, pat), At)
    assert_same_vec(vec_dense(got), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("union", [True, False])
def test_udt_ewise(kind, union):
    I, J, X = _data(6)
    I2, J2, X2 = _data(7)
    f_j = gb.eWiseAdd if union else gb.eWiseMult
    f_t = gt.eWiseAdd if union else gt.eWiseMult
    want = f_j(gb.Matrix.new(JP, N, N), None, None, JMUL, jmat(I, J, X),
               jmat(I2, J2, X2))
    got = f_t(tempty(kind), None, None, TMUL, tmat(kind, I, J, X),
              tmat(kind, I2, J2, X2))
    assert_same(port_dense(got), want)


@pytest.mark.parametrize("kind", KINDS)
def test_udt_apply_to_and_from_struct(kind):
    I, J, X = _data(8)
    to_j = gb.UnaryOp("TO_XN", lambda v: {"x": v * 2.0, "n": v * 0 + 3},
                      JP, gb.FP64)
    to_t = gt.UnaryOp("TO_XN", lambda v: {"x": v * 2.0, "n": v * 0 + 3},
                      TP, gt.FP64)
    fr_j = gb.UnaryOp("FROM_XN", lambda v: v["x"] + v["n"], gb.FP64, JP)
    fr_t = gt.UnaryOp("FROM_XN", lambda v: v["x"] + v["n"], gt.FP64, TP)
    want = gb.apply(gb.Matrix.new(JP, N, N), None, None, to_j,
                    gb.Matrix.from_dense(_dense(I, J, X, N, N)[0]["x"],
                                         gb.FP64,
                                         pattern=_dense(I, J, X, N, N)[1]))
    src = {"csr": gt.CsrMatrix, "csc": gt.CscMatrix}
    if kind in src:
        A = src[kind].from_coo(I, J, X["x"], N, N, device=CPU)
    elif kind == "hyper":
        A = gt.hyper_from_coo(I, J, X["x"], N, N, device=CPU)
    else:
        A = gt.Matrix.from_coo(I, J, X["x"], N, N, device=CPU)
    got = gt.apply(tempty(kind), None, None, to_t, A)
    assert_same(port_dense(got), want)
    assert port_dense(got)[0]["n"].dtype == np.int64
    back_j = gb.apply(gb.Matrix.new(gb.FP64, N, N), None, None, fr_j,
                      jmat(I, J, X))
    if kind in src:
        C0 = src[kind].from_coo([], [], np.zeros(0), N, N, device=CPU)
    elif kind == "hyper":
        C0 = gt.hyper_from_coo([], [], np.zeros(0), N, N, device=CPU)
    else:
        C0 = gt.Matrix.new(gt.FP64, N, N, device=CPU)
    back = gt.apply(C0, None, None, fr_t, tmat(kind, I, J, X))
    if isinstance(back, gt.HyperMatrix):
        back = back.to_csr()
    if not isinstance(back, gt.Matrix):
        back = back.to_matrix()
    np.testing.assert_allclose(back.to_dense(), np.asarray(
        back_j.to_dense()), rtol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_udt_select(kind):
    I, J, X = _data(9)
    sj = gb.SelectOp("NBIG", lambda i, j, x, k: x["n"] > k)
    st = gt.SelectOp("NBIG", lambda i, j, x, k: x["n"] > k)
    want = gb.select(gb.Matrix.new(JP, N, N), None, None, sj,
                     jmat(I, J, X), 1)
    got = gt.select(tempty(kind), None, None, st, tmat(kind, I, J, X), 1)
    assert_same(port_dense(got), want)
    want = gb.select(gb.Matrix.new(JP, N, N), None, None, "tril",
                     jmat(I, J, X), 0)
    got = gt.select(tempty(kind), None, None, "tril", tmat(kind, I, J, X), 0)
    assert_same(port_dense(got), want)


@pytest.mark.parametrize("kind", KINDS)
def test_udt_reduce_vector_and_scalar(kind):
    I, J, X = _data(10)
    want = gb.reduce_to_vector(gb.Vector.new(JP, N), None, None, JMON,
                               jmat(I, J, X))
    got = gt.reduce_to_vector(gt.Vector.new(TP, N, device=CPU), None, None,
                              TMON, tmat(kind, I, J, X))
    assert_same_vec(vec_dense(got), want)
    sj = gb.reduce_to_scalar(None, JMON, jmat(I, J, X))
    st = gt.reduce_to_scalar(None, TMON, tmat(kind, I, J, X))
    assert int(st["n"]) == int(sj["n"])
    assert abs(float(st["x"]) - float(sj["x"])) <= 1e-12 * abs(
        float(sj["x"])) + 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_udt_transpose(kind):
    I, J, X = _data(11, m=N, n=N - 3)
    want = gb.transpose(gb.Matrix.new(JP, N - 3, N), None, None,
                        jmat(I, J, X, N, N - 3))
    got = gt.transpose(tempty(kind, N - 3, N), None, None,
                       tmat(kind, I, J, X, N, N - 3))
    assert_same(port_dense(got), want)


@pytest.mark.parametrize("kind", KINDS)
def test_udt_extract_assign(kind):
    I, J, X = _data(12)
    rows, cols = [1, 3, 4, 8, 11], [0, 2, 5, 6]
    want = gb.extract(gb.Matrix.new(JP, 5, 4), None, None, jmat(I, J, X),
                      rows, cols)
    got = gt.extract(tempty(kind, 5, 4), None, None, tmat(kind, I, J, X),
                     rows, cols)
    assert_same(port_dense(got), want)
    Is, Js, Xs = _data(13, m=5, n=4, nnz=12)
    want = gb.assign(jmat(I, J, X), None, JADD, jmat(Is, Js, Xs, 5, 4),
                     rows, cols)
    got = gt.assign(tmat(kind, I, J, X), None, TADD,
                    tmat(kind, Is, Js, Xs, 5, 4), rows, cols)
    assert_same(port_dense(got), want)


@pytest.mark.parametrize("kind", KINDS)
def test_udt_pending_fold_with_accum(kind):
    I, J, X = _data(14)
    Aj, At = jmat(I, J, X), tmat(kind, I, J, X)
    rng = np.random.default_rng(15)
    for k in range(40):
        i, j = int(rng.integers(0, N)), int(rng.integers(0, N))
        v = {"x": float(rng.normal()), "n": int(rng.integers(1, 4))}
        acc = (JADD, TADD) if k % 3 else (None, None)
        Aj = Aj.setElement(v, i, j, accum=acc[0], blocking=False)
        At = At.setElement(v, i, j, accum=acc[1], blocking=False)
    assert_same(port_dense(At.wait()), Aj.wait())


def test_udt_valued_mask_raises():
    I, J, X = _data(16)
    for kind in ("csr", "bitmap", "hyper"):
        A = tmat(kind, I, J, X)
        with pytest.raises(TypeError, match="mask"):
            gt.mxm(tempty(kind), A, None, TSR, A, A)


def test_udt_leaves_live_in_field_storage():
    I, J, X = _data(17)
    for kind in KINDS:
        A = tmat(kind, I, J, X)
        vals = A.values if not isinstance(A, gt.CscMatrix) else A.tr.values
        assert vals["x"].dtype == torch.float64
        assert vals["n"].dtype == torch.int64


@pytest.mark.cuda
def test_udt_and_complex_launch_no_kernel_on_card():
    """On CUDA tensors a user-defined and a complex product take the
    generic engines: every kernel gate refuses them without raising,
    and no kernel launches (K4's valdot plan, K5's SpMV tiles, K6's
    tropical product and K7 are all passed by)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphblas_tpu_torch import _build
    dev = "cuda"
    before = dict(_build.launches)
    I, J, X = _data(20, m=300, n=300, nnz=6000)
    A = gt.CsrMatrix.from_coo(I, J, X, 300, 300, type=TP, device=dev)
    E = {"x": np.zeros(0), "n": np.zeros(0, np.int64)}
    z = np.zeros(0, np.int64)
    C0 = gt.CsrMatrix.from_coo(z, z, E, 300, 300, type=TP, device=dev)
    C = gt.mxm(C0, A, None, TSR, A, A, gt.Descriptor(mask_structure=True))
    u = gt.Vector.from_dense({"x": np.ones(300), "n": np.ones(300,
                                                              np.int64)},
                             TP, device=dev)
    w = gt.mxv(gt.Vector.new(TP, 300, device=dev), None, None, TSR, A, u)
    Ab = A.to_matrix()
    Cb = gt.mxm(gt.Matrix.new(TP, 300, 300, device=dev), None, None, TSR,
                Ab, Ab)
    rng = np.random.default_rng(21)
    for t in (gt.FC32, gt.FC64):
        V = (rng.normal(size=len(I)) + 1j * rng.normal(size=len(I))).astype(
            t.dtype)
        Z = gt.CsrMatrix.from_coo(I, J, V, 300, 300, type=t, device=dev)
        Z._options["bsr_spmv"] = True        # past the device test
        Cz = gt.mxm(gt.CsrMatrix.from_coo(z, z, np.zeros(0, t.dtype), 300,
                                          300, device=dev), Z, None,
                    gt.semiring.plus_times[t], Z, Z)
        wz = gt.mxv(gt.Vector.new(t, 300, device=dev), None, None,
                    gt.semiring.plus_times[t], Z,
                    gt.Vector.from_dense(np.ones(300, t.dtype), t,
                                         device=dev))
        Zb = Z.to_matrix()
        Cm = gt.mxm(gt.Matrix.new(t, 300, 300, device=dev), None, None,
                    gt.semiring.min_plus[t], Zb, Zb)
        assert Cz.nvals > 0 and wz.nvals() > 0 and Cm.nvals() > 0
    torch.cuda.synchronize()
    assert C.nvals > 0 and w.nvals() > 0 and Cb.nvals() > 0
    assert dict(_build.launches) == before
