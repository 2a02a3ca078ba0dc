"""PyTorch port, the rest of the algebra: the unary families, the select
ops, ``resolve_unary`` / ``resolve_select``, ``promote`` /
``cast_value`` / ``zero_of`` and ``core/options``, in parity with the
JAX package.

The same numpy inputs (zeros, ones, negatives and each type's extremes
mixed in) go through each JAX operator and its port over the 11 builtin
types.  Every result must be equal exactly, floats included (one IEEE
operation per value), NaN where NaN.  The resolve part mirrors
``tests/test_resolve.py``'s unary and select cases, and its typed
errors on the new entry points."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import graphblas_tpu as gb
from graphblas_tpu.core import ops as jops
from graphblas_tpu.core import options as joptions
from graphblas_tpu.core import types as jtypes
from graphblas_tpu.core.resolve import resolve_select as j_resolve_select
from graphblas_tpu.core.resolve import resolve_unary as j_resolve_unary
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import ops as tops
from graphblas_tpu_torch.core import options as toptions
from graphblas_tpu_torch.core import types as ttypes
from graphblas_tpu_torch.core.resolve import (UnsupportedOp, resolve_select,
                                              resolve_unary)

from .test_torch_algebra import ALL_TYPES, _from_t, _same, _to_t, _values

UNARY = sorted(tops.unary.names())


def test_unary_catalog_matches_jax():
    assert UNARY == sorted(jops.unary.names())
    assert sorted(tops.select.names()) == sorted(jops.select.names())


@pytest.mark.parametrize("opname", UNARY)
def test_unary_op_matches_jax(opname):
    """Each unary op over the 11 builtin types: MINV(0) is the type's
    maximum on the integers (2^64 - 1 on UINT64), MINV(2) is 0, AINV
    wraps."""
    rng = np.random.default_rng(zlib.crc32(opname.encode()))
    for tname in ALL_TYPES:
        x = _values(rng, tname)
        jop = jops.unary[opname][getattr(jtypes, tname)]
        top = tops.unary[opname][ttypes.type_by_name(tname)]
        assert (top.name, top.ztype.name, top.xtype.name) == \
            (jop.name, jop.ztype.name, jop.xtype.name)
        want = np.asarray(jop(jnp.asarray(x)))
        got = _from_t(top(_to_t(x, tname)), top.ztype)
        _same(got, np.broadcast_to(want, got.shape).astype(want.dtype),
              top.ztype.is_float)


@pytest.mark.parametrize("tname", ["INT8", "UINT8", "INT64", "UINT64"])
def test_integer_minv_and_ainv(tname):
    t = ttypes.type_by_name(tname)
    info = np.iinfo(t.dtype)
    x = np.array([0, 1, 2, info.max], t.dtype)
    minv = _from_t(tops.unary.minv[t](_to_t(x, tname)), t)
    assert minv[0] == info.max and minv[1] == 1 and minv[2] == 0
    ainv = _from_t(tops.unary.ainv[t](_to_t(x, tname)), t)
    assert np.array_equal(ainv, (np.zeros_like(x) - x).astype(t.dtype))


def test_unary_op_typed_names():
    for name in ("AINV_INT32", "GrB_MINV_UINT64", "abs_fp32"):
        top = tops.unary_op(name)
        jop = jops.unary_op(name)
        assert (top.name, top.xtype.name) == (jop.name, jop.xtype.name)


@pytest.mark.parametrize("selname", ["tril", "triu", "diag", "offdiag",
                                     "nonzero"])
def test_select_ops_match_jax(selname):
    rng = np.random.default_rng(4)
    i, j = np.indices((7, 9))
    x = rng.integers(-2, 3, (7, 9)).astype(np.float64)
    for k in (-2, 0, 1):
        want = np.asarray(jops.select[selname](
            jnp.asarray(i), jnp.asarray(j), jnp.asarray(x), k))
        got = tops.select[selname](torch.from_numpy(i), torch.from_numpy(j),
                                   torch.from_numpy(x), k)
        assert np.array_equal(got.numpy(), want)
    assert gt.selectop[selname] is tops.select[selname]


def test_promote_cast_value_zero_of_match_jax():
    specials = [0, 1, -1, 2.5, -2.5, 1e20, -1e20, float("nan"),
                float("inf"), True, 300, np.uint64(2 ** 63 + 5)]
    for a in ttypes.BUILTIN_TYPES:
        ja = getattr(jtypes, a.name)
        assert ttypes.zero_of(a) == jtypes.zero_of(ja)
        assert np.asarray(ttypes.zero_of(a)).dtype == a.dtype
        for b in ttypes.BUILTIN_TYPES:
            assert ttypes.promote(a, b).name == \
                jtypes.promote(ja, getattr(jtypes, b.name)).name
        for v in specials:
            if isinstance(v, np.uint64) and a.is_float:
                continue
            got, want = ttypes.cast_value(v, a), jtypes.cast_value(v, ja)
            assert np.asarray(got).dtype == np.asarray(want).dtype == a.dtype
            assert got == want or (np.isnan(got) and np.isnan(want)), \
                (v, a.name, got, want)


def test_options_match_jax():
    try:
        assert toptions.Options() == toptions.Options(
            **vars(joptions.Options()))
        gt.init(gt.BLOCKING)
        assert gt.get_option("mode") == "blocking"
        gt.set_option("chunk", 1 << 10)
        assert gt.global_options().chunk == 1 << 10
        with pytest.raises(KeyError):
            gt.set_option("no_such_option", 1)
    finally:
        gt.init()
    assert gt.get_option("mode") == gt.NONBLOCKING


# ---------------------------------------------------------------------------
# resolve (the unary and select parts of tests/test_resolve.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def abc():
    def csr(I, J, X):
        return gt.CsrMatrix.from_coo(np.array(I, int), np.array(J, int),
                                     np.array(X, np.float32), 2, 2,
                                     type=gt.FP32, device="cpu")
    return csr([0, 1], [1, 0], [1.5, 2.5]), csr([0, 1], [0, 1], [3., 4.]), \
        csr([], [], [])


def test_resolve_unary_and_select():
    u = gt.unary.ainv[gt.FP32]
    assert resolve_unary(u) is u
    assert resolve_unary("ainv", "op", gt.INT8).xtype.name == "INT8"
    assert resolve_unary("GrB_MINV_FP64").name == \
        j_resolve_unary("GrB_MINV_FP64").name
    s = gt.selectop.tril
    assert resolve_select(s) is s
    for name in ("triu", "GxB_OFFDIAG", " nonzero "):
        assert resolve_select(name).name == j_resolve_select(name).name
    with pytest.raises(UnsupportedOp, match="unary op"):
        resolve_unary("nonsense", "op", gt.FP32)
    with pytest.raises(UnsupportedOp, match="unary op"):
        resolve_unary("ainv")               # no type to infer from
    with pytest.raises(UnsupportedOp, match="select op"):
        resolve_select("junk")
    with pytest.raises(UnsupportedOp, match="SelectOp"):
        resolve_select(3)


def test_string_ops_resolve(abc):
    A, B, C = abc
    assert gt.eWiseAdd(C, None, None, "plus", A, B).nvals == 4
    assert gt.eWiseMult(C, None, None, "times", A, B).nvals == 0
    assert gt.eWiseAdd(C, None, "plus", "GrB_PLUS_FP32", A, B).nvals == 4
    assert gt.apply(C, None, None, "abs", A).nvals == 2
    assert gt.select(C, None, None, "offdiag", A).nvals == 2
    assert gt.reduce_to_scalar(None, "plus", A) == pytest.approx(4.0)
    w = gt.Vector.new(gt.FP32, 2, device="cpu")
    assert gt.reduce_to_vector(w, None, None, "plus", A).nvals() == 2


def test_junk_op_raises_typed(abc):
    A, B, C = abc
    with pytest.raises(UnsupportedOp, match="eWiseAdd op"):
        gt.eWiseAdd(C, None, None, "nonsense", A, B)
    with pytest.raises(UnsupportedOp, match="eWiseMult op"):
        gt.eWiseMult(C, None, None, 3.14, A, B)
    with pytest.raises(UnsupportedOp, match="apply op"):
        gt.apply(C, None, None, object(), A)
    with pytest.raises(UnsupportedOp, match="select op"):
        gt.select(C, None, None, "junk", A)
    with pytest.raises(UnsupportedOp, match="reduce op"):
        gt.reduce_to_scalar(None, "nonsense", A)
    with pytest.raises(UnsupportedOp, match="reduce op"):
        gt.reduce_to_vector(gt.Vector.new(gt.FP32, 2, device="cpu"), None,
                            None, "snake", A)
    with pytest.raises(UnsupportedOp, match="accum"):
        gt.eWiseAdd(C, None, object(), "plus", A, B)
    with pytest.raises(UnsupportedOp, match="kron op"):
        gt.kron(C, None, None, "zzz", A, B)
    with pytest.raises(UnsupportedOp, match="transpose accum"):
        gt.transpose(C, None, "zzz", A)
    with pytest.raises(gt.UnsupportedContainer):
        gt.apply(C, None, None, "abs", np.eye(2))


def test_jax_udt_has_no_port_counterpart():
    """Both packages keep the 11 builtin types in their table, and both
    have the complex types and ``Type.udt`` beside it (the port gained
    them with user-defined types; their values are
    tests/test_torch_udt.py's and test_torch_complex.py's)."""
    assert len(ttypes.BUILTIN_TYPES) == len(jtypes.BUILTIN_TYPES) == 11
    for name in ("FC32", "FC64"):
        assert getattr(gt, name).dtype == getattr(gb, name).dtype
    tu = gt.Type.udt("P", x=gt.FP64, n=gt.INT32)
    ju = gb.Type.udt("P", x=gb.FP64, n=gb.INT32)
    assert tu.is_udt and ju.is_udt
    assert [k for k, _ in tu.fields] == [k for k, _ in ju.fields]
