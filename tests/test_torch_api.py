"""PyTorch port: the API surface (mirror of ``test_api.py``) — options,
import/export, printing/checking, user-defined objects, aliases,
checkpoints, timers, typecasts, ``isequal`` and misc GrB parity
behaviors.

Each test runs the JAX test's calls on the port (``device="cpu"``) and,
where the JAX package computes the same function, holds the port's
answer against it on the same seeded numpy inputs: exact for patterns,
integers and booleans, float values within rtol 1e-12 (FP64
reassociation) unless a test states otherwise.
"""

import io

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu import user_objects as juo
from graphblas_tpu_torch import user_objects as uo

DEV = "cpu"


def _rand(m, n, seed, density=0.4):
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    dense = rng.normal(size=(m, n)) * mask
    return gt.Matrix.from_dense(dense, gt.FP64, pattern=mask,
                                device=DEV), dense, mask


def _close(a, b, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0)


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

def test_options_roundtrip():
    gt.init(gt.BLOCKING)
    assert gt.get_option("mode") == gt.BLOCKING
    gt.set_option("format", gt.BY_COL)
    assert gt.get_option("format") == gt.BY_COL
    with pytest.raises(KeyError):
        gt.set_option("nope", 1)
    gt.init()  # reset
    assert gt.get_option("mode") == gt.NONBLOCKING


# ---------------------------------------------------------------------------
# import / export
# ---------------------------------------------------------------------------

def test_export_import_csr_roundtrip():
    A, dense, mask = _rand(8, 11, 0)
    nr, nc, p, j, x = gt.export_csr(A)
    assert nr == 8 and nc == 11 and p[-1] == mask.sum()
    want = gb.export_csr(gb.Matrix.from_dense(dense, gb.FP64, pattern=mask))
    for a, b in zip((p, j, x), want[2:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    B = gt.import_csr(nr, nc, p, j, x, gt.FP64, device=DEV)
    assert np.allclose(B.to_matrix().to_dense(), dense)


def test_export_import_csc_roundtrip():
    A, dense, mask = _rand(9, 5, 1)
    nr, nc, p, i, x = gt.export_csc(A)
    want = gb.export_csc(gb.Matrix.from_dense(dense, gb.FP64, pattern=mask))
    for a, b in zip((p, i, x), want[2:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    B = gt.import_csc(nr, nc, p, i, x, gt.FP64, device=DEV)
    assert np.allclose(B.to_matrix().to_dense(), dense)


def test_import_hyper_csr():
    # rows 2 and 5 present only
    h = [2, 5]
    p = [0, 2, 3]
    idx = [1, 3, 0]
    val = [1.0, 2.0, 3.0]
    A = gt.import_hyper_csr(7, 4, 2, h, p, idx, val, gt.FP64, device=DEV)
    M = A.to_matrix()
    assert M.extractElement(2, 1) == 1.0
    assert M.extractElement(2, 3) == 2.0
    assert M.extractElement(5, 0) == 3.0
    assert M.nvals() == 3


def test_vector_import_export():
    v = gt.import_vector(10, [1, 5, 7], [1.0, 2.0, 3.0], device=DEV)
    n, I, X = gt.export_vector(v)
    assert n == 10
    assert I.tolist() == [1, 5, 7]
    assert np.allclose(X, [1.0, 2.0, 3.0])


# ---------------------------------------------------------------------------
# fprint / check
# ---------------------------------------------------------------------------

def test_fprint_all_objects():
    bufs = []
    for pkg, kw in ((gt, {"device": DEV}), (gb, {})):
        buf = io.StringIO()
        rng = np.random.default_rng(2)
        mask = rng.random((4, 4)) < 0.4
        dense = rng.normal(size=(4, 4)) * mask
        A = pkg.Matrix.from_dense(dense, pkg.FP64, pattern=mask, **kw)
        pkg.fprint(A, "A", pkg.COMPLETE, buf)
        v = pkg.Vector.from_dense(np.arange(3.0), **kw)
        pkg.fprint(v, "v", pkg.SHORT, buf)
        pkg.fprint(pkg.FP64, "fp64", pkg.SHORT, buf)
        pkg.fprint(pkg.unary.ainv[pkg.FP64], "ainv", pkg.SHORT, buf)
        pkg.fprint(pkg.binary.plus[pkg.FP64], "plus", pkg.SHORT, buf)
        pkg.fprint(pkg.monoid.plus[pkg.FP64], "plusmon", pkg.SHORT, buf)
        pkg.fprint(pkg.semiring.plus_times[pkg.FP64], "sr", pkg.SHORT, buf)
        pkg.fprint(pkg.REPLACE, "desc", pkg.SHORT, buf)
        bufs.append(buf.getvalue())
    out = bufs[0]
    assert "nrows: 4 ncols: 4" in out
    assert "GraphBLAS Semiring" in out
    assert "number of entries" in out
    assert bufs[0] == bufs[1]


def test_check_catches_corruption():
    A, dense, mask = _rand(3, 3, 3)
    assert gt.check(A)
    # corrupt: nonzero value at absent position
    bad = gt.Matrix(torch.ones((3, 3), dtype=torch.float64),
                    torch.zeros((3, 3), dtype=torch.bool), gt.FP64)
    with pytest.raises(ValueError):
        gt.check(bad)


# ---------------------------------------------------------------------------
# user objects (the m4 example set)
# ---------------------------------------------------------------------------

def test_my_complex_semiring():
    rng = np.random.default_rng(4)
    Ad = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    Bd = rng.normal(size=(4, 2)) + 1j * rng.normal(size=(4, 2))
    A = gt.Matrix.from_dense(Ad, gt.FC64, device=DEV)
    B = gt.Matrix.from_dense(Bd, gt.FC64, device=DEV)
    C = gt.mxm(gt.Matrix.new(gt.FC64, 3, 2, device=DEV), None, None,
               uo.my_complex_plus_times, A, B)
    assert np.allclose(C.to_dense(), Ad @ Bd)
    Cj = gb.mxm(gb.Matrix.new(gb.FC64, 3, 2), None, None,
                juo.my_complex_plus_times, gb.Matrix.from_dense(Ad, gb.FC64),
                gb.Matrix.from_dense(Bd, gb.FC64))
    _close(C.to_dense(), Cj.to_dense())


def test_my_complex_plus_keeps_infinite_parts():
    """The user PLUS adds part by part: 0 + inf*j stays inf*j (torch's
    complex add would give nan+inf*j), as in the JAX package."""
    x = torch.tensor([0j, 1 + 2j], dtype=torch.complex128)
    y = torch.tensor([complex(0, np.inf), 3 - 1j], dtype=torch.complex128)
    got = uo.my_complex_plus(x, y).numpy()
    import jax.numpy as jnp
    want = np.asarray(juo.my_complex_plus(jnp.asarray(x.numpy()),
                                          jnp.asarray(y.numpy())))
    np.testing.assert_array_equal(got, want)


def test_my_plus_rdiv_and_scale():
    A = gt.Matrix.from_dense(np.array([[2.0, 4.0]]), device=DEV)
    B = gt.Matrix.from_dense(np.array([[8.0, 4.0]]), device=DEV)
    C = gt.eWiseMult(gt.Matrix.new(gt.FP64, 1, 2, device=DEV), None, None,
                     uo.my_plus_rdiv, A, B)
    assert np.allclose(C.to_dense(), [[4.0, 1.0]])
    D = gt.apply(gt.Matrix.new(gt.FP64, 1, 2, device=DEV), None, None,
                 uo.my_scale, A)
    assert np.allclose(D.to_dense(), [[4.0, 8.0]])


def test_my_band_select():
    A = gt.Matrix.from_dense(np.arange(16.0).reshape(4, 4), device=DEV)
    C = gt.select(gt.Matrix.new(gt.FP64, 4, 4, device=DEV), None, None,
                  uo.my_band, A, (0, 1))
    pat = C.pattern_np()
    i, j = np.nonzero(pat)
    assert ((j - i >= 0) & (j - i <= 1)).all()
    assert pat.sum() == 7
    Cj = gb.select(gb.Matrix.new(gb.FP64, 4, 4), None, None, juo.my_band,
                   gb.Matrix.from_dense(np.arange(16.0).reshape(4, 4)),
                   (0, 1))
    np.testing.assert_array_equal(pat, Cj.pattern_np())


def test_my_max_terminal_monoid():
    assert uo.my_max_terminal.terminal == 1e308
    v = gt.Vector.from_dense(np.array([1.0, 99.0, 3.0]), device=DEV)
    assert gt.reduce_to_scalar(None, uo.my_max_terminal, v) == 99.0


def test_pagerank_semiring_is_the_models_objects():
    sr = uo.pagerank_semiring()
    assert sr.add.type.name == gt.models.PAGERANK_TYPE.name
    assert sr.name == juo.pagerank_semiring().name


# ---------------------------------------------------------------------------
# aliases (reference GB_mex_mxm_alias tests): C<C> = C*C etc.
# ---------------------------------------------------------------------------

def test_mxm_alias():
    A, dense, mask = _rand(6, 6, 5)
    sr = gt.semiring.plus_times[gt.FP64]
    C = gt.mxm(A, A, None, sr, A, A)
    want = (dense @ dense) * mask
    got = C.to_dense()
    assert np.allclose(got[mask], want[mask])
    Aj = gb.Matrix.from_dense(dense, gb.FP64, pattern=mask)
    Cj = gb.mxm(Aj, Aj, None, gb.semiring.plus_times[gb.FP64], Aj, Aj)
    np.testing.assert_array_equal(C.pattern_np(), Cj.pattern_np())
    _close(got, Cj.to_dense())


def test_assign_alias():
    A, dense, mask = _rand(5, 5, 6)
    out = gt.assign(A, A, None, A)  # C<C> = C
    assert np.allclose(out.to_dense(), dense)
    np.testing.assert_array_equal(out.pattern_np(), mask)


def test_ewise_alias():
    A, dense, mask = _rand(4, 4, 7)
    C = gt.eWiseAdd(A, None, None, gt.binary.plus[gt.FP64], A, A)
    assert np.allclose(C.to_dense(), 2 * dense)


# ---------------------------------------------------------------------------
# struct-of-struct (wildtype) UDT
# ---------------------------------------------------------------------------

def test_nested_udt():
    inner = gt.Type.udt("inner", a=gt.FP64, b=gt.FP32)
    outer = gt.Type.udt("outer", x=inner, y=gt.INT32)
    M = gt.Matrix.new(outer, 2, 2, device=DEV)
    M = M.setElement({"x": {"a": 1.5, "b": 2.5}, "y": 7}, 0, 1)
    got = M.extractElement(0, 1)
    assert got["x"]["a"] == 1.5 and got["y"] == 7
    assert M.nvals() == 1


# ---------------------------------------------------------------------------
# checkpoint / timer / iterators
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    from graphblas_tpu_torch import io as gtio
    A, dense, mask = _rand(7, 9, 8)
    p = tmp_path / "a.npz"
    gtio.save_matrix(p, A)
    B = gtio.load_matrix(p, device=DEV)
    assert np.allclose(B.to_dense(), dense)
    assert np.array_equal(B.pattern_np(), mask)
    v = gt.Vector.from_coo([1, 4], [2.0, 3.0], 6, device=DEV)
    pv = tmp_path / "v.npz"
    gtio.save_vector(pv, v)
    w = gtio.load_vector(pv, device=DEV)
    assert w.extractElement(4) == 3.0
    assert w.nvals() == 2


def test_timer(tmp_path):
    from graphblas_tpu_torch.utils import timer
    timer.simple_tic()
    assert timer.simple_toc() >= 0
    with timer.device_timer() as t:
        pass
    assert "s" in t
    with timer.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_row_col_iterators():
    A, dense, mask = _rand(5, 6, 9)
    seen = {}
    for i, cols, vals in A.rows():
        seen[i] = (cols, vals)
        assert np.array_equal(cols, np.nonzero(mask[i])[0])
        assert np.allclose(vals, dense[i][cols])
    assert set(seen) == set(np.nonzero(mask.any(axis=1))[0])
    for j, rows, vals in A.cols():
        assert np.array_equal(rows, np.nonzero(mask[:, j])[0])
        assert np.allclose(vals, dense[:, j][rows])


# ---------------------------------------------------------------------------
# typecast parity: NaN/Inf -> int (GB_CAST, GB.h:2925-2948) + isequal
# ---------------------------------------------------------------------------

def test_cast_nonfinite_float_to_int():
    from graphblas_tpu_torch.core.types import cast, cast_value
    x = torch.tensor([1.9, -1.9, np.nan, np.inf, -np.inf],
                     dtype=torch.float64)
    got = cast(x, gt.INT32).numpy()
    assert got.tolist() == [1, -1, 0, 2**31 - 1, -(2**31)]
    got8 = cast(x, gt.INT8).numpy()
    assert got8[2] == 0 and got8[3] == 127 and got8[4] == -128
    assert cast_value(np.inf, gt.UINT8) == 255
    assert cast_value(-np.inf, gt.INT16) == -32768
    assert cast_value(np.nan, gt.INT64) == 0


def test_isequal():
    from graphblas_tpu_torch.utils.compare import isequal
    A, dense, mask = _rand(4, 5, 10)
    B = gt.Matrix.from_dense(dense, gt.FP64, pattern=mask, device=DEV)
    assert isequal(A, B)
    C = B.setElement(99.0, 0, 0)
    assert not isequal(A, C)
    # same values in a different type: not equal unless typecheck off
    ints = np.round(dense * 4) * mask  # exactly representable in f32
    E64 = gt.Matrix.from_dense(ints, gt.FP64, pattern=mask, device=DEV)
    E32 = gt.Matrix.from_dense(ints, gt.FP32, pattern=mask, device=DEV)
    assert not isequal(E64, E32)          # type differs
    assert isequal(E64, E32, typecheck=False)


def test_cast_saturation_host_device_consistent():
    from graphblas_tpu_torch.core.types import cast, cast_value
    for v in (3e9, -3e9, 1e300, -1e300):
        dev = int(cast(torch.tensor([v], dtype=torch.float64),
                       gt.INT32)[0])
        host = int(cast_value(v, gt.INT32))
        assert dev == host, (v, dev, host)
    assert cast_value(3e9, gt.INT32) == 2**31 - 1


def test_isequal_nan_and_mixed():
    from graphblas_tpu_torch.utils.compare import isequal
    d = np.array([[np.nan, 1.0]])
    p = np.array([[True, True]])
    A = gt.Matrix.from_dense(d, gt.FP64, pattern=p, device=DEV)
    assert not isequal(A, A.dup())    # NaN != NaN (isequal.c)
    # small-magnitude errors not masked by an absolute term
    B = gt.Matrix.from_dense(np.array([[0.0, 1.0]]), gt.FP64, pattern=p,
                             device=DEV)
    C = gt.Matrix.from_dense(np.array([[1e-9, 1.0]]), gt.FP64, pattern=p,
                             device=DEV)
    assert not isequal(B, C, rtol=1e-12)
    # builtin vs UDT with typecheck off -> False, not TypeError
    U = gt.Type.udt("u", a=gt.FP64)
    M = gt.Matrix.new(U, 1, 2, device=DEV)
    assert not isequal(B, M, typecheck=False)


def test_checkpoint_udt(tmp_path):
    from graphblas_tpu_torch import io as gtio
    U = gt.Type.udt("pt", a=gt.FP64, b=gt.INT32)
    M = gt.Matrix.new(U, 3, 3, device=DEV)
    M = M.setElement({"a": 1.5, "b": 2}, 0, 1)
    M = M.setElement({"a": -0.5, "b": 7}, 2, 0)
    p = tmp_path / "u.npz"
    gtio.save_matrix(p, M)
    N = gtio.load_matrix(p, type=U, device=DEV)
    assert N.extractElement(0, 1) == {"a": 1.5, "b": 2}
    assert N.extractElement(2, 0)["b"] == 7
    assert N.nvals() == 2


def test_masked_mxm_pattern_exactness():
    # entries of M where A*B has no structural contribution must be
    # ABSENT in the result, not explicit zeros
    from graphblas_tpu_torch import sparse as sp
    A = np.zeros((130, 130), bool)
    A[0, 1] = A[1, 0] = True      # only one pair
    M = np.ones((130, 130), bool)
    Am = gt.Matrix.from_dense(A, gt.BOOL, pattern=A, device=DEV)
    Mm = gt.Matrix.from_dense(M, gt.BOOL, pattern=M, device=DEV)
    C = sp.masked_mxm(Mm, Am, Am)
    pat = C.pattern_np()
    # structure of A*A' here: (0,0) and (1,1) only
    want = np.zeros_like(M)
    want[0, 0] = want[1, 1] = True
    assert np.array_equal(pat, want)


# ---------------------------------------------------------------------------
# second-round review regressions
# ---------------------------------------------------------------------------

def test_cast_64bit_saturation():
    from graphblas_tpu_torch.core.types import cast, cast_value
    x = torch.tensor([1e19, -1e19, 2.0**63, 5.0], dtype=torch.float64)
    got = cast(x, gt.INT64).numpy()
    assert got[0] == np.iinfo(np.int64).max
    assert got[1] == np.iinfo(np.int64).min
    assert got[2] == np.iinfo(np.int64).max
    assert got[3] == 5
    gotu = cast(torch.tensor([2e19, -1.0], dtype=torch.float64),
                gt.UINT64).numpy().view(np.uint64)
    assert gotu[0] == np.iinfo(np.uint64).max
    assert gotu[1] == 0
    # f32 source into int32: bound rounds up in f32
    y = torch.tensor([2.14748365e9, -2.2e9, 7.0], dtype=torch.float32)
    got32 = cast(y, gt.INT32).numpy()
    assert got32[0] == 2**31 - 1 and got32[1] == -(2**31)
    assert got32[2] == 7
    assert cast_value(1e19, gt.INT64) == np.iinfo(np.int64).max


def test_monoid_minmax_ignore_nan():
    v = gt.Vector.from_dense(np.array([np.nan, 5.0, 7.0]), device=DEV)
    assert gt.reduce_to_scalar(None, gt.monoid.min[gt.FP64], v) == 5.0
    assert gt.reduce_to_scalar(None, gt.monoid.max[gt.FP64], v) == 7.0


def test_nonblocking_mode_default():
    gt.init(gt.NONBLOCKING)
    v = gt.Vector.new(gt.FP64, 4, device=DEV).setElement(1.5, 2)
    assert v._pending                      # deferred under nonblocking
    assert v.extractElement(2) == 1.5      # reads force completion
    gt.init(gt.BLOCKING)
    w = gt.Vector.new(gt.FP64, 4, device=DEV).setElement(2.5, 1)
    assert not w._pending                  # folded immediately
    gt.init()


def test_wait_batched_many_tuples():
    gt.init(gt.NONBLOCKING)
    M = gt.Matrix.new(gt.FP64, 20, 20, device=DEV)
    rng = np.random.default_rng(0)
    want = np.zeros((20, 20))
    for _ in range(200):
        i, j = int(rng.integers(20)), int(rng.integers(20))
        x = float(rng.normal())
        M = M.setElement(x, i, j)          # no accum: last write wins
        want[i, j] = x
    M = M.wait()
    pat = want != 0
    assert np.allclose(M.to_dense()[pat], want[pat])
    # accum run: duplicates fold in order
    V = gt.Vector.new(gt.FP64, 5, device=DEV)
    for x in (1.0, 2.0, 3.0):
        V = V.setElement(x, 2, accum=gt.binary.plus[gt.FP64])
    V = V.wait()
    assert V.extractElement(2) == 6.0
    gt.init()


def test_from_coo_udt_raises():
    U = gt.Type.udt("u2", a=gt.FP64)
    with pytest.raises(TypeError):
        gt.Matrix.from_coo([0], [0], [{"a": 1.0}], 2, 2, type=U,
                           device=DEV)


def test_kron_custom_op():
    Ad = np.array([[2.0, 0.0], [0.0, 5.0]])
    Bd = np.array([[3.0, 4.0]])
    A = gt.Matrix.from_dense(Ad, gt.FP64, pattern=Ad != 0, device=DEV)
    B = gt.Matrix.from_dense(Bd, gt.FP64, pattern=Bd != 0, device=DEV)
    C = gt.models.kron_generate(A, B, op=gt.binary.min[gt.FP64])
    want = gt.kron(gt.Matrix.new(gt.FP64, 2, 4, device=DEV), None, None,
                   gt.binary.min[gt.FP64], A, B)
    assert np.allclose(C.to_dense(), want.to_dense())


def test_normalize_indices_forms():
    from graphblas_tpu_torch.utils.indices import normalize_indices, ALL
    assert normalize_indices(ALL, 5).tolist() == [0, 1, 2, 3, 4]
    assert normalize_indices(None, 3).tolist() == [0, 1, 2]
    assert normalize_indices(":", 3).tolist() == [0, 1, 2]
    assert normalize_indices(2, 5).tolist() == [2]
    assert normalize_indices(slice(1, 4), 5).tolist() == [1, 2, 3]
    assert normalize_indices(slice(4, None, -2), 5).tolist() == [4, 2, 0]
    assert normalize_indices(range(1, 3), 5).tolist() == [1, 2]
    assert normalize_indices([3, 1, 1], 5, unique=True).tolist() == [1, 3]
    with pytest.raises(gt.IndexOutOfBounds):
        normalize_indices([7], 5)
    with pytest.raises(gt.InvalidValue):
        normalize_indices(np.zeros((2, 2), np.int64), 5)


def test_isequal_vectors_and_rtol():
    from graphblas_tpu_torch.utils.compare import isequal
    v = gt.Vector.from_coo([0, 2], [1.0, 2.0], 4, device=DEV)
    w = gt.Vector.from_coo([0, 2], [1.0, 2.0 + 1e-13], 4, device=DEV)
    assert not isequal(v, w)
    assert isequal(v, w, rtol=1e-9)
    assert not isequal(v, gt.Matrix.new(gt.FP64, 4, 1, device=DEV))
    u = gt.Vector.from_coo([0], [1.0], 4, device=DEV)
    assert not isequal(v, u)  # different pattern


def test_isequal_across_containers():
    """The port's isequal takes every container, in any pairing of one
    kind: CSR, CSC, hypersparse and bitmap holding the same entries are
    equal; one changed value, a NaN or a missing entry is not."""
    from graphblas_tpu_torch import sparse as sp
    from graphblas_tpu_torch.utils.compare import isequal
    A, dense, mask = _rand(7, 6, 12, density=0.5)
    I, J = np.nonzero(mask)
    X = dense[I, J]
    kinds = [A, sp.CsrMatrix.from_coo(I, J, X, 7, 6, device=DEV),
             sp.CscMatrix.from_coo(I, J, X, 7, 6, device=DEV),
             sp.hyper_from_coo(I, J, X, 7, 6, device=DEV),
             sp.HyperCscMatrix.from_coo(I, J, X, 7, 6, device=DEV)]
    for a in kinds:
        for b in kinds:
            assert isequal(a, b)
    Y = X.copy()
    Y[3] += 1e-6
    assert not isequal(kinds[1], sp.CsrMatrix.from_coo(I, J, Y, 7, 6,
                                                       device=DEV))
    assert isequal(kinds[1], sp.CsrMatrix.from_coo(I, J, Y, 7, 6,
                                                   device=DEV), rtol=1e-3)
    Y[3] = np.nan
    N = sp.CsrMatrix.from_coo(I, J, Y, 7, 6, device=DEV)
    assert not isequal(N, N)
    assert not isequal(kinds[2], sp.CscMatrix.from_coo(
        I[1:], J[1:], X[1:], 7, 6, device=DEV))
    s = sp.SparseVec.from_coo([1, 5], [2.0, 3.0], 1 << 40, device=DEV)
    assert isequal(s, s.dup())
    assert not isequal(s, kinds[0])
    U = gt.Type.udt("ab", a=gt.FP64, b=gt.INT32)
    Xs = {"a": X, "b": np.arange(len(I), dtype=np.int32)}
    S1 = sp.CsrMatrix.from_coo(I, J, Xs, 7, 6, type=U, device=DEV)
    assert isequal(S1, sp.CsrMatrix.from_coo(I, J, Xs, 7, 6, type=U,
                                             device=DEV))
    Xs2 = {"a": X, "b": np.arange(len(I), dtype=np.int32) + 1}
    assert not isequal(S1, sp.CsrMatrix.from_coo(I, J, Xs2, 7, 6, type=U,
                                                 device=DEV))


def test_isequal_unsigned_and_mixed_types():
    """UINT64 values above 2^63 compare by value, within one type and
    across types with typecheck off."""
    from graphblas_tpu_torch.utils.compare import isequal
    big = np.array([2**64 - 1, 2**63 + 5, 3], np.uint64)
    a = gt.Vector.from_dense(big, gt.UINT64, device=DEV)
    assert isequal(a, a.dup())
    assert isequal(a, a.dup(), rtol=1e-12)
    b = gt.Vector.from_dense(big.astype(np.float64), gt.FP64, device=DEV)
    assert isequal(a, b, typecheck=False)
    c = gt.Vector.from_dense(np.array([1, 2, 3], np.int8), gt.INT8,
                             device=DEV)
    d = gt.Vector.from_dense(np.array([1, 2, 3], np.uint16), gt.UINT16,
                             device=DEV)
    assert not isequal(c, d) and isequal(c, d, typecheck=False)


def test_simple_rand_scalar_batch_agree():
    from graphblas_tpu_torch.utils.simple_rand import SimpleRand
    a, b = SimpleRand(7), SimpleRand(7)
    xs = [a.rand_x() for _ in range(10)]
    ys = b.rand_x_batch(10)
    assert np.allclose(xs, ys, rtol=0, atol=0)
    a2, b2 = SimpleRand(3), SimpleRand(3)
    assert [a2.rand() for _ in range(5)] == b2.rand_batch(5).tolist()
    assert SimpleRand(9).rand_i() == SimpleRand(9).rand_i()
    s = SimpleRand(4)
    s.seed(11)
    t = SimpleRand(11)
    assert s.rand() == t.rand()


def test_third_review_regressions():
    # bounds validation on element access
    M = gt.Matrix.new(gt.INT32, 2, 2, device=DEV)
    with pytest.raises(gt.IndexOutOfBounds):
        M.setElement(5, 99, 0)
    with pytest.raises(gt.IndexOutOfBounds):
        M.extractElement(99, 0)
    with pytest.raises(gt.IndexOutOfBounds):
        gt.Vector.new(gt.FP64, 3, device=DEV).removeElement(7)
    # to_dense(fill) for UDT
    U = gt.Type.udt("tdr", a=gt.FP64)
    W = gt.Matrix.new(U, 2, 2, device=DEV).setElement({"a": 3.0}, 0, 0)
    d = W.to_dense(fill=-1.0)
    assert d["a"][0][0] == 3.0 and d["a"][1][1] == -1.0
    # string accum rejected
    with pytest.raises(TypeError):
        gt.Vector.new(gt.FP64, 2, device=DEV).setElement(
            1.0, 0, accum="PLUS", blocking=False).wait()
    # pattern shape validation
    with pytest.raises(gt.DimensionMismatch):
        gt.Matrix.from_dense(np.ones((3, 4)), pattern=np.ones(4, bool),
                             device=DEV)


def test_vxm_csr_noncommutative_flip():
    from graphblas_tpu_torch import sparse as sp
    rng = np.random.default_rng(80)
    mask = rng.random((6, 6)) < 0.6
    Ad = (rng.integers(1, 9, (6, 6)) * mask).astype(np.float64)
    I, J = np.nonzero(mask)
    A = sp.CsrMatrix.from_coo(I, J, Ad[I, J], 6, 6, device=DEV)
    u = gt.Vector.from_dense(np.arange(1.0, 7.0), device=DEV)
    for srname in ("plus_first", "plus_second", "min_minus"):
        sr = gt.semiring[srname][gt.FP64]
        got = gt.vxm(gt.Vector.new(gt.FP64, 6, device=DEV), None, None, sr,
                     u, A, gt.TRAN1)
        want = gt.vxm(gt.Vector.new(gt.FP64, 6, device=DEV), None, None, sr,
                      u, A.to_matrix(), gt.TRAN1)
        assert np.allclose(got.to_dense(), want.to_dense()), srname
        assert np.array_equal(got.pattern_np(), want.pattern_np())
    # dimension check on the fast path
    with pytest.raises(gt.DimensionMismatch):
        gt.mxv(gt.Vector.new(gt.FP64, 6, device=DEV), None, None,
               gt.semiring.plus_times[gt.FP64], A,
               gt.Vector.from_dense(np.ones(5), device=DEV))


def test_tropical_times_not_poisoned():
    # MIN_TIMES with absent partners must NOT take the dense fill path
    Av = np.array([[2.0, -1.0]], np.float32)
    Ap = np.array([[True, True]])
    Bv = np.array([[3.0], [0.0]], np.float32)
    Bp = np.array([[True], [False]])   # B[1,0] absent
    A = gt.Matrix.from_dense(Av, gt.FP32, pattern=Ap, device=DEV)
    B = gt.Matrix.from_dense(Bv, gt.FP32, pattern=Bp, device=DEV)
    C = gt.mxm(gt.Matrix.new(gt.FP32, 1, 1, device=DEV), None, None,
               gt.semiring.min_times[gt.FP32], A, B)
    assert C.extractElement(0, 0) == 6.0   # only the present pair


def test_hyper_export_roundtrip(rng):
    """export_hyper_csr ∘ import_hyper_csr == identity (O(nvec) lists)."""
    from graphblas_tpu_torch.sparse.container import CsrMatrix
    n = 500
    I = rng.integers(0, n, 60)
    J = rng.integers(0, n, 60)
    lin = np.unique(I * n + J)
    I, J = lin // n, lin % n
    X = rng.random(len(I))
    A = CsrMatrix.from_coo(I, J, X, n, n, type=gt.FP64,
                           sum_duplicates=False, device=DEV)
    nr, nc, nvec, h, p, idx, vals = gt.export_hyper_csr(A)
    assert nvec == len(np.unique(I))
    B = gt.import_hyper_csr(nr, nc, nvec, h, p, idx, vals, type=gt.FP64,
                            device=DEV)
    Ib, Jb, Xb = B.extractTuples()
    assert np.array_equal(Ib, I) and np.array_equal(Jb, J)
    assert np.allclose(Xb, X[np.lexsort((J, I))])


def test_per_matrix_options():
    from graphblas_tpu_torch import grb
    A = gt.Matrix.new(gt.FP64, 4, 4, device=DEV)
    B = gt.Matrix.new(gt.FP64, 4, 4, device=DEV)
    grb.GxB_set(A, "format", "by_col")
    assert grb.GxB_get(A, "format") == "by_col"
    # other objects fall back to the global scope
    assert grb.GxB_get(B, "format") == grb.GxB_Global_Option_get("format")
    # option survives wait()/setElement round
    A2 = A.setElement(1.0, 0, 0).wait()
    assert grb.GxB_get(A2, "format") == "by_col"


def test_per_matrix_options_sparse_containers():
    """On the sparse containers the option sits beside the engines'
    caches: it survives setElement/wait (a new pattern), the caches do
    not, and a field naming a cache is refused."""
    from graphblas_tpu_torch import grb
    from graphblas_tpu_torch import sparse as sp
    from graphblas_tpu_torch.core.errors import InvalidValue
    I, J = np.array([0, 1, 2]), np.array([1, 2, 0])
    for A in (sp.CsrMatrix.from_coo(I, J, [1.0, 2.0, 3.0], 3, 3,
                                    device=DEV),
              sp.hyper_from_coo(I, J, [1.0, 2.0, 3.0], 1 << 40, 1 << 40,
                                device=DEV)):
        grb.GxB_set(A, "format", "by_col")
        grb.GxB_set(A, "hyper_ratio", 0.25)
        A._options["_spgemm_chunks"] = "stale plan"
        A2 = A.setElement(5.0, 1, 1).wait()
        assert grb.GxB_get(A2, "format") == "by_col"
        assert grb.GxB_get(A2, "hyper_ratio") == 0.25
        assert "_spgemm_chunks" not in A2._options
        for field in ("host_pattern", "bitdot_plan", "_spmm_plan"):
            with pytest.raises(InvalidValue):
                grb.GxB_set(A, field, 1)


def test_bsr_spmv_option_is_settable():
    """``bsr_spmv`` is a per-matrix option the SpMV gate reads: set
    through the facade, True forces a dense tile past the device test,
    False opts the matrix out of the tile kernel."""
    from graphblas_tpu_torch import grb
    from graphblas_tpu_torch import sparse as sp
    I, J = np.nonzero(np.ones((128, 128), bool))
    sr = gt.semiring.plus_times[gt.FP32]

    def tile():
        return sp.CsrMatrix.from_coo(I, J, np.ones(len(I), np.float32),
                                     128, 128, type=gt.FP32, device=DEV)
    A, B = tile(), tile()
    assert not sp.bsr_spmv_ok(sr, A)      # the CPU takes no tile engine
    grb.GxB_set(A, "bsr_spmv", True)
    assert sp.bsr_spmv_ok(sr, A)
    grb.GxB_set(B, "bsr_spmv", False)
    assert grb.GxB_get(B, "bsr_spmv") is False
    assert not sp.bsr_spmv_ok(sr, B)


def test_grb_error_message():
    from graphblas_tpu_torch import grb
    try:
        gt.Matrix.from_coo([99], [0], [1.0], 4, 4, type=gt.FP64, device=DEV)
    except gt.IndexOutOfBounds:
        pass
    msg = grb.GrB_error()
    assert "INDEX_OUT_OF_BOUNDS" in msg and "4x4" in msg


def test_fprint_check_all_sparse_containers():
    """GxB_*_fprint / GB_check across all four storage formats x all
    verbosity levels (round-4 printing coverage)."""
    from graphblas_tpu_torch.sparse import (CsrMatrix, CscMatrix,
                                            HyperCscMatrix, hyper_from_coo)
    I = np.array([0, 1, 3]); J = np.array([2, 0, 3])
    X = np.array([1.0, 2.0, 3.0])
    objs = [
        CsrMatrix.from_coo(I, J, X, 4, 4, type=gt.FP64, device=DEV),
        CscMatrix.from_coo(I, J, X, 4, 4, type=gt.FP64, device=DEV),
        hyper_from_coo(I, J, X, 1 << 40, 1 << 40, type=gt.FP64, device=DEV),
        HyperCscMatrix.from_coo(I, J, X, 1 << 40, 1 << 40, type=gt.FP64,
                                device=DEV),
    ]
    for obj in objs:
        for level in (gt.SILENT, gt.SUMMARY, gt.SHORT, gt.COMPLETE):
            buf = io.StringIO()
            gt.fprint(obj, type(obj).__name__, level, buf)
            if level > gt.SILENT:
                assert str(obj.nvals) in buf.getvalue() or \
                    "nvals" in buf.getvalue()
        assert gt.check(obj)


def test_hyper_conform_after_a_product_carries_options():
    """A CSR operand of a product holds the ESC plan under a tuple key;
    ``hyper_conform`` then carries its per-object options (not the
    caches) to the hypersparse copy, with the JAX package's entries."""
    from graphblas_tpu import sparse as jsp
    from graphblas_tpu_torch import grb
    from graphblas_tpu_torch import sparse as sp
    I, J, X = [0, 1, 2, 2], [1, 2, 0, 2], [1.0, 2.0, 3.0, 4.0]
    A = sp.CsrMatrix.from_coo(I, J, X, 3, 3, device=DEV)
    sp.csr_spgemm(gt.semiring.plus_times[gt.FP64], A, A)
    assert any(not isinstance(k, str) for k in A._options)
    grb.GxB_set(A, "format", "by_col")
    H = sp.hyper_conform(A, sp.GxB_ALWAYS_HYPER)
    assert isinstance(H, sp.HyperMatrix)
    assert H._options == {"format": "by_col"}
    Aj = jsp.CsrMatrix.from_coo(I, J, X, 3, 3)
    Hj = jsp.hyper_conform(Aj, jsp.GxB_ALWAYS_HYPER)
    for a, b in zip(H.extractTuples(), Hj.extractTuples()):
        np.testing.assert_array_equal(a, np.asarray(b))
