"""PyTorch port, the native tuple library bridge (``io/native.py``) and
the bit packing (``sparse/bitpack.py``): parity with the JAX package.

Mirrors ``tests/test_native.py`` and the bitpack/R-MAT parts of
``tests/test_sparse.py``.  Both packages load the same
``native/libgbtpu_native.so``, so where it is built their outputs must
be equal exactly; where it is not (as on the card's machine), each
function returns None and the numpy form it stands for gives the same
result, which these tests check too by hiding the library."""

import io as _io

import numpy as np
import pytest

from graphblas_tpu.io import native as jnative
from graphblas_tpu.io.read import read_triplets
from graphblas_tpu.models.rmat import rmat_graph as jax_rmat_graph
from graphblas_tpu.sparse.bitpack import pack_rows as jax_pack_rows
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.io import native

LIB = native.native_lib()
needs_lib = pytest.mark.skipif(LIB is None, reason="native lib not built")


@pytest.fixture
def no_lib(monkeypatch):
    """The port's bridge as on a machine without the built library."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


@needs_lib
def test_parse_triplets_matches_jax(tmp_path):
    p = tmp_path / "g.tsv"
    p.write_text("0 0 1.5\n1 2 -3e2\n% comment\n2 1\n\n3 3 0.25\n")
    out = native.parse_triplets_native(str(p))
    assert out is not None
    I, J, X = out
    assert I.tolist() == [0, 1, 2, 3] and J.tolist() == [0, 2, 1, 3]
    assert X.tolist() == [1.5, -300.0, 1.0, 0.25]
    for a, b in zip(out, jnative.parse_triplets_native(str(p))):
        assert np.array_equal(a, b)


@needs_lib
def test_parse_matches_python_and_fallback(tmp_path):
    rng = np.random.default_rng(0)
    I = rng.integers(0, 100, 500)
    J = rng.integers(0, 100, 500)
    X = rng.normal(size=500)
    body = "".join(f"{i} {j} {x:.17g}\n" for i, j, x in zip(I, J, X))
    p = tmp_path / "r.tsv"
    p.write_text(body)
    In, Jn, Xn = native.parse_triplets_native(str(p))
    assert np.array_equal(In, I) and np.array_equal(Jn, J)
    assert np.array_equal(Xn, X)       # strtod round trip of 17 digits
    If, Jf, Xf = read_triplets(_io.StringIO(body))   # the numpy form
    assert np.array_equal(In, If) and np.array_equal(Xn, Xf)


@needs_lib
def test_parse_edge_case_floats(tmp_path):
    cases = ["1.7976931348623157e308", "9.999999999999999e-5",
             "2.2250738585072014e-308", "5e-324", "nan", "inf", "-inf",
             "-0.0", "123456789.123456789", "1e-45", "3.3333333333333335",
             "0.1", "6.02214076e23", "-2.718281828459045e-100"]
    p = tmp_path / "edge.tsv"
    p.write_text("".join(f"{i} 0 {c}\n" for i, c in enumerate(cases)))
    I, J, X = native.parse_triplets_native(str(p))
    assert np.array_equal(X, np.array([float(c) for c in cases]),
                          equal_nan=True)


@needs_lib
def test_parse_malformed_raises(tmp_path):
    for body in ("0 0 1.5\n1 1 oops\n", "0 0 1.5\n7\n"):
        p = tmp_path / "bad.tsv"
        p.write_text(body)
        with pytest.raises(ValueError):
            native.parse_triplets_native(str(p))
        with pytest.raises(ValueError):
            jnative.parse_triplets_native(str(p))


def test_functions_without_the_library(no_lib, tmp_path):
    """Without the library every bridge function returns None, and the
    callers' numpy forms give the library's results."""
    p = tmp_path / "m.tsv"
    p.write_text("0 1 2.0\n")
    I = np.array([3, 1, 1, 0])
    J = np.array([0, 2, 2, 3])
    assert native.native_lib() is None
    assert native.parse_triplets_native(str(p)) is None
    assert native.sym_dedup_native(I, J, 4) is None
    assert native.sort_pairs_native(I, J, 4, 4) is None
    assert native.sort_dedup_native(I, J, np.ones(4), "PLUS") is None
    A = gt.CsrMatrix.from_coo(I, J, np.ones(4), 4, 4, device="cpu")
    assert A.nvals == 3 and A.extractElement(1, 2) == 2.0
    Is, Js = gt.symmetrize_pattern(I, J, 4)
    k = I != J
    lin = np.unique(np.concatenate([I[k] * 4 + J[k], J[k] * 4 + I[k]]))
    assert np.array_equal(Is, lin // 4) and np.array_equal(Js, lin % 4)


@needs_lib
@pytest.mark.parametrize("dup", ["PLUS", "FIRST", "SECOND", "MIN", "MAX",
                                 "TIMES"])
def test_sort_dedup_matches_jax(dup):
    rng = np.random.default_rng(1)
    I = rng.integers(0, 20, 300)
    J = rng.integers(0, 20, 300)
    X = rng.normal(size=300)
    out = native.sort_dedup_native(I, J, X, dup)
    assert out is not None
    for a, b in zip(out, jnative.sort_dedup_native(I, J, X, dup)):
        assert np.array_equal(a, b)
    assert (np.diff(out[0] * 20 + out[1]) > 0).all()


def test_sym_dedup_matches_numpy_and_jax():
    rng = np.random.default_rng(4)
    n = 300
    I = rng.integers(0, n, 5_000)
    J = rng.integers(0, n, 5_000)
    I[::11] = J[::11]                      # self loops must be dropped
    r = native.sym_dedup_native(I, J, n)
    if r is None:
        pytest.skip("native library not built")
    want = gt.symmetrize_pattern(I, J, n)   # the numpy form
    assert np.array_equal(r[0], want[0]) and np.array_equal(r[1], want[1])
    rj = jnative.sym_dedup_native(I, J, n)
    assert np.array_equal(r[0], rj[0]) and np.array_equal(r[1], rj[1])
    # the self-loop sentinel may tie with an all-ones real key
    r2 = native.sym_dedup_native(np.array([5, 44]), np.array([5, 23]), 46)
    assert set(zip(r2[0].tolist(), r2[1].tolist())) == {(44, 23), (23, 44)}


def test_pair_sort_matches_lexsort():
    rng = np.random.default_rng(3)
    I = rng.integers(0, 500, 20_000)
    J = rng.integers(0, 700, 20_000)
    sp = native.sort_pairs_native(I, J, 500, 700)
    if sp is None:
        pytest.skip("native library not built")
    order = np.lexsort((J, I))
    assert np.array_equal(sp[0], I[order]) and np.array_equal(sp[1],
                                                              J[order])
    assert np.array_equal(sp[2], order)


@pytest.mark.parametrize("shape", [(7, 100), (3, 1), (5, 257)])
def test_pack_rows_matches_jax(shape):
    rng = np.random.default_rng(2)
    pat = rng.random(shape) < 0.4
    got = gt.pack_rows(pat, device="cpu")
    want = np.asarray(jax_pack_rows(pat))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(gt.popcount(got).sum(dim=1).numpy(),
                          pat.sum(axis=1))
    assert np.array_equal(gt.pack_pattern(pat, device="cpu").numpy(),
                          got.numpy())


def test_rmat_generator():
    I, J = gt.rmat_edges(10, 8, seed=3)
    n = 1 << 10
    assert I.max() < n and J.max() < n and (I != J).all()
    lin = set(zip(I.tolist(), J.tolist()))
    assert all((j, i) in lin for i, j in list(lin)[:100])
    A = gt.models.rmat_graph(8, 4, seed=5, device="cpu")
    assert A.nrows == 256 and A.type == gt.FP32
    assert A.nvals == len(gt.rmat_edges(8, 4, seed=5)[0])
    assert jax_rmat_graph(8, 4, seed=5).nvals == A.nvals
