"""PyTorch port: ``fprint`` and ``check`` (``core/printing.py``).

``fprint`` text must equal the JAX package's byte for byte, at every
level, for every builtin type, FC32/FC64 and a struct type, on each
container (bitmap Matrix and Vector, CSR, CSC, HyperMatrix,
HyperCscMatrix), and for types, ops, monoids, semirings and
descriptors.  The same seeded numpy inputs go into both packages.
``check`` must accept what each builds and reject a corrupted copy with
``ValueError``, as the JAX package's does.
"""

import io

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu import sparse as jsp
from graphblas_tpu_torch import sparse as tsp

DEV = "cpu"
TYPES = ["BOOL", "INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32",
         "INT64", "UINT64", "FP32", "FP64", "FC32", "FC64"]
LEVELS = (gb.SILENT, gb.SUMMARY, gb.SHORT, gb.COMPLETE)


def _text(mod, obj, level, name="x"):
    buf = io.StringIO()
    mod.fprint(obj, name, level, buf)
    return buf.getvalue()


def _same_text(a, b, levels=LEVELS):
    for level in levels:
        assert _text(gb, a, level) == _text(gt, b, level), level


def _values(name, shape, rng):
    v = rng.normal(size=shape) * 50
    if name.startswith("FC"):
        v = v + 1j * rng.normal(size=shape)
    if name.startswith("U") or name == "BOOL":
        v = np.abs(v)
    return v.astype(getattr(gb, name).dtype)


def _containers(name, shape, seed):
    """(JAX object, port object) pairs of each container kind over the
    same entries (a 6 x 7 grid has more than 30 entries at density 0.8,
    so SHORT shows its "..." line)."""
    rng = np.random.default_rng(seed)
    tj, tt = getattr(gb, name), getattr(gt, name)
    pat = rng.random(shape) < 0.8
    v = _values(name, shape, rng)
    I, J = np.nonzero(pat)
    X = v[I, J]
    big = 1 << 40
    return {
        "Matrix": (gb.Matrix.from_dense(v, tj, pattern=pat),
                   gt.Matrix.from_dense(v, tt, pattern=pat, device=DEV)),
        "Vector": (gb.Vector.from_dense(v.ravel(), tj, pattern=pat.ravel()),
                   gt.Vector.from_dense(v.ravel(), tt, pattern=pat.ravel(),
                                        device=DEV)),
        "CsrMatrix": (jsp.CsrMatrix.from_coo(I, J, X, *shape, type=tj),
                      tsp.CsrMatrix.from_coo(I, J, X, *shape, type=tt,
                                             device=DEV)),
        "CscMatrix": (jsp.CscMatrix.from_coo(I, J, X, *shape, type=tj),
                      tsp.CscMatrix.from_coo(I, J, X, *shape, type=tt,
                                             device=DEV)),
        "HyperMatrix": (jsp.hyper_from_coo(I * 997, J, X, big, shape[1],
                                           type=tj),
                        tsp.hyper_from_coo(I * 997, J, X, big, shape[1],
                                           type=tt, device=DEV)),
        "HyperCscMatrix": (jsp.HyperCscMatrix.from_coo(I, J * 991, X, big,
                                                       big, type=tj),
                           tsp.HyperCscMatrix.from_coo(I, J * 991, X, big,
                                                       big, type=tt,
                                                       device=DEV)),
    }


@pytest.mark.parametrize("kind", ["Matrix", "Vector", "CsrMatrix",
                                  "CscMatrix", "HyperMatrix",
                                  "HyperCscMatrix"])
@pytest.mark.parametrize("name", TYPES)
def test_fprint_containers_match_jax(name, kind):
    for seed, shape in ((0, (6, 7)), (1, (3, 4))):
        a, b = _containers(name, shape, seed)[kind]
        _same_text(a, b)
        assert gt.check(b)


def test_fprint_empty_and_pending_match_jax():
    """Empty containers, and a CSR container whose header counts the
    stored entries while the listing folds its pending tuples."""
    for name in ("FP64", "INT32", "BOOL"):
        tj, tt = getattr(gb, name), getattr(gt, name)
        _same_text(gb.Matrix.new(tj, 3, 4),
                   gt.Matrix.new(tt, 3, 4, device=DEV))
        _same_text(gb.Vector.new(tj, 5), gt.Vector.new(tt, 5, device=DEV))
    I, J, X = [0, 1], [1, 2], [1.5, -2.25]
    Aj = jsp.CsrMatrix.from_coo(I, J, X, 3, 3, type=gb.FP64)
    At = tsp.CsrMatrix.from_coo(I, J, X, 3, 3, type=gt.FP64, device=DEV)
    Aj = Aj.setElement(7.0, 2, 0, blocking=False)
    At = At.setElement(7.0, 2, 0, blocking=False)
    for level in (gb.SUMMARY, gb.SHORT):
        assert _text(gb, Aj, level) == _text(gt, At, level)


def _struct_both(rng, n=5):
    inner_j = gb.Type.udt("inner", a=gb.FP64, b=gb.FP32)
    inner_t = gt.Type.udt("inner", a=gt.FP64, b=gt.FP32)
    pat = rng.random((n, n)) < 0.7
    a = rng.normal(size=(n, n))
    b = rng.normal(size=(n, n)).astype(np.float32)
    c = rng.integers(-9, 9, (n, n)).astype(np.int32)
    flat_j = gb.Type.udt("pt", x=gb.FP64, w=gb.FP32, k=gb.INT32)
    flat_t = gt.Type.udt("pt", x=gt.FP64, w=gt.FP32, k=gt.INT32)
    vals = {"x": a, "w": b, "k": c}
    return ((gb.Matrix.from_dense(vals, flat_j, pattern=pat),
             gt.Matrix.from_dense(vals, flat_t, pattern=pat, device=DEV)),
            (_struct_vector(gb.Vector.new(flat_j, n), vals, pat),
             _struct_vector(gt.Vector.new(flat_t, n, device=DEV), vals,
                            pat)),
            (inner_j, inner_t))


def _struct_vector(v, vals, pat):
    """Row 0 of the struct values as a Vector, by setElement (the JAX
    package's Vector.from_dense takes no dict of field arrays)."""
    for i in np.nonzero(pat[0])[0]:
        v = v.setElement({k: a[0, i] for k, a in vals.items()}, int(i))
    return v.wait()


def test_fprint_struct_matches_jax():
    """A struct type prints its fields in sorted-name order, each as
    its field's numpy scalar; the sparse listing of a struct prints the
    header alone."""
    rng = np.random.default_rng(5)
    (Mj, Mt), (vj, vt), (inner_j, inner_t) = _struct_both(rng)
    _same_text(Mj, Mt)
    _same_text(vj, vt)
    _same_text(inner_j, inner_t)
    U_j = gb.Type.udt("pt", x=gb.FP64, k=gb.INT32)
    U_t = gt.Type.udt("pt", x=gt.FP64, k=gt.INT32)
    X = {"x": np.array([1.5, -2.0]), "k": np.array([3, 4], np.int32)}
    Cj = jsp.CsrMatrix.from_coo([0, 2], [1, 0], X, 3, 3, type=U_j)
    Ct = tsp.CsrMatrix.from_coo([0, 2], [1, 0], X, 3, 3, type=U_t,
                                device=DEV)
    _same_text(Cj, Ct)


def test_fprint_algebra_matches_jax():
    """Every builtin type's Type, the unary/binary op families, the 44
    monoids, the 960 semirings, the select ops and the descriptors."""
    for name in TYPES:
        _same_text(getattr(gb, name), getattr(gt, name))
    for fam in ("identity", "ainv", "minv", "lnot", "one", "abs"):
        for t in gb.BUILTIN_TYPES:
            try:
                a = gb.unary[fam][t]
            except (KeyError, AttributeError):
                continue
            _same_text(a, gt.unary[fam][getattr(gt, t.name)])
    for fam in ("first", "second", "min", "max", "plus", "minus", "times",
                "div", "eq", "ne", "gt", "lt", "ge", "le", "lor", "land",
                "lxor", "pair", "rminus", "rdiv", "iseq", "isne", "isgt",
                "islt", "isge", "isle"):
        for t in gb.BUILTIN_TYPES:
            try:
                a = gb.binary[fam][t]
            except (KeyError, AttributeError):
                continue
            _same_text(a, gt.binary[fam][getattr(gt, t.name)])
    assert set(gb.MONOIDS) == set(gt.MONOIDS)
    for k in gb.MONOIDS:
        _same_text(gb.MONOIDS[k], gt.MONOIDS[k])
    assert set(gb.SEMIRINGS) == set(gt.SEMIRINGS)
    for k in gb.SEMIRINGS:
        _same_text(gb.SEMIRINGS[k], gt.SEMIRINGS[k], (gb.SUMMARY, gb.SHORT))
    for op in ("tril", "triu", "diag", "offdiag", "nonzero"):
        _same_text(getattr(gb.selectop, op), getattr(gt.selectop, op))
    for d in ("NULL_DESC", "REPLACE", "SCMP", "TRAN0", "TRAN1", "RT", "ST",
              "RST", "TT"):
        _same_text(getattr(gb, d), getattr(gt, d))
    _same_text(gb.Descriptor(axb_method="dot"),
               gt.Descriptor(axb_method="dot"))


def test_fprint_user_objects_match_jax():
    from graphblas_tpu import user_objects as juo
    from graphblas_tpu_torch import user_objects as tuo
    for name in ("my_complex_plus", "my_complex_times",
                 "my_complex_plus_monoid", "my_complex_plus_times",
                 "my_plus_rdiv", "my_scale", "my_band", "my_max_terminal"):
        _same_text(getattr(juo, name), getattr(tuo, name))
    _same_text(juo.pagerank_semiring(), tuo.pagerank_semiring())


def test_fprint_unknown_object_raises():
    with pytest.raises(TypeError):
        gt.fprint(object(), "x", gt.SHORT, io.StringIO())
    with pytest.raises(TypeError):
        gt.check(3)


def _csr(n=6):
    I = np.array([0, 0, 1, 3, 3, 5])
    J = np.array([1, 4, 2, 0, 5, 5])
    return tsp.CsrMatrix.from_coo(I, J, np.arange(6.0), n, n, device=DEV)


def _corrupt(A, field, at, value):
    """A copy of the CSR/hyper container A with A.<field>[at] = value."""
    B = A._shallow()
    t = getattr(A, field).clone()
    t[at] = value
    setattr(B, field, t)
    return B


@pytest.mark.parametrize("field,at,value,msg", [
    ("indices", 0, 4, "sorted"),          # swaps row 0's pair order
    ("indices", 2, 9, "out of range"),
    ("indptr", 2, 1, "monotone"),
    ("indptr", -1, 5, "endpoints"),
    ("indices", 7, 0, "sentinel"),
    ("rowids", 7, 0, "sentinel"),
    ("rowids", 4, 0, "sorted"),
])
def test_check_csr_rejects_corruption(field, at, value, msg):
    A = _csr()
    assert gt.check(A) and gt.check(tsp.CscMatrix(A))
    with pytest.raises(ValueError, match=msg):
        gt.check(_corrupt(A, field, at, value))


def test_check_csr_swapped_pair_matches_jax():
    """One pair of column indices swapped within a row: both packages'
    ``check`` raise ``ValueError``."""
    A = _csr()
    I, J, X = A.extractTuples()
    Aj = jsp.CsrMatrix.from_coo(I, J, X, 6, 6)
    import jax.numpy as jnp
    Jj = np.asarray(Aj.indices).copy()
    Jj[[0, 1]] = Jj[[1, 0]]
    Bj = jsp.CsrMatrix(Aj.indptr, jnp.asarray(Jj), Aj.rowids, Aj.values,
                       Aj.nvals, 6, 6, Aj.type)
    Jt = A.indices.clone()
    Jt[[0, 1]] = Jt[[1, 0]]
    Bt = _corrupt(A, "indices", slice(0, 2), Jt[:2])
    with pytest.raises(ValueError):
        gb.check(Bj)
    with pytest.raises(ValueError):
        gt.check(Bt)


@pytest.mark.parametrize("field,at,value,msg", [
    ("h", 1, 0, "row list"),
    ("hptr", 1, 9, "pointers"),
    ("indices", 1, 0, "entries"),
    ("indices", 0, 1 << 50, "entries"),
    ("rowids", 0, 7, "entries"),
])
def test_check_hyper_rejects_corruption(field, at, value, msg):
    ids = np.array([3, 3, 90, 1 << 45])
    A = tsp.hyper_from_coo(ids, np.array([5, 9, 2, 1]), np.arange(4.0),
                           1 << 46, 1 << 46, device=DEV)
    assert gt.check(A)
    with pytest.raises(ValueError, match=msg):
        gt.check(_corrupt(A, field, at, value))


def test_check_bitmap_rejects_value_at_absent_position():
    """The bitmap invariant (absent values are 0), on the same corrupt
    container in both packages."""
    import jax.numpy as jnp
    bad_j = gb.Matrix(jnp.ones((3, 3)), jnp.zeros((3, 3), bool), gb.FP64)
    bad_t = gt.Matrix(torch.ones((3, 3), dtype=torch.float64),
                      torch.zeros((3, 3), dtype=torch.bool), gt.FP64)
    with pytest.raises(ValueError):
        gb.check(bad_j)
    with pytest.raises(ValueError):
        gt.check(bad_t)
    ok = gt.Matrix.from_dense(np.eye(3), device=DEV)
    assert gt.check(ok)
