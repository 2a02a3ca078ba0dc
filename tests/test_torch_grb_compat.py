"""PyTorch port: the GrB_* compatibility facade (mirror of
``test_grb_compat.py``): reference-style call sequences through
``graphblas_tpu_torch.grb`` on the CPU, held against the same calls
through ``graphblas_tpu.grb`` (exact patterns and integers, FP64 values
within rtol 1e-12), and the name catalog against the JAX facade's.
"""

import numpy as np
import pytest

from graphblas_tpu import grb as jgrb
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu_torch import grb
from graphblas_tpu_torch.ops.flopcount import (axb_flopcount,
                                               choose_axb_method,
                                               jax_engine_name,
                                               last_axb_method)

DEV = "cpu"


def test_every_jax_name_exists():
    """Every GrB_*/GxB_* name of the JAX facade exists in the port's,
    of the same kind (function, type, op, monoid, semiring, constant)."""
    missing = [k for k in jgrb.__all__ if not hasattr(grb, k)]
    assert missing == []
    assert set(grb.__all__) == set(jgrb.__all__)
    for k in jgrb.__all__:
        a, b = getattr(jgrb, k), getattr(grb, k)
        assert type(a).__name__ == type(b).__name__, k
        if hasattr(a, "name") and isinstance(getattr(a, "name"), str):
            assert a.name == b.name, k
        elif isinstance(a, (str, int, type(None))):
            assert a == b, k


def test_catalog_sizes():
    semirings = [k for k in grb.__all__ if "_MONOID" not in k and
                 k.startswith("GxB_") and
                 getattr(grb, k).__class__.__name__ == "Semiring"]
    monoids = [k for k in grb.__all__ if k.endswith("_MONOID")]
    assert len(semirings) == 960
    assert len(monoids) == 44


def test_reference_style_mxm():
    grb.GrB_init()
    A = grb.GrB_Matrix_new(grb.GrB_FP64, 3, 3, device=DEV)
    A = grb.GrB_Matrix_build(A, [0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0])
    B = grb.GrB_Matrix_dup(A)
    C = grb.GrB_Matrix_new(grb.GrB_FP64, 3, 3, device=DEV)
    C = grb.GrB_mxm(C, None, None, grb.GxB_PLUS_TIMES_FP64, A, B, None)
    assert grb.GrB_Matrix_nvals(C) == 3
    assert grb.GrB_Matrix_extractElement(C, 0, 2) == 2.0
    I, J, X = grb.GrB_Matrix_extractTuples(C)
    assert len(I) == 3
    Aj = jgrb.GrB_Matrix_build(jgrb.GrB_Matrix_new(jgrb.GrB_FP64, 3, 3),
                               [0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0])
    Cj = jgrb.GrB_mxm(jgrb.GrB_Matrix_new(jgrb.GrB_FP64, 3, 3), None, None,
                      jgrb.GxB_PLUS_TIMES_FP64, Aj, Aj, None)
    for a, b in zip((I, J, X), jgrb.GrB_Matrix_extractTuples(Cj)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _bfs_levels(g, device_kw):
    # the bfs5m setup sequence, written as in the reference
    n = 4
    ring = [(0, 1), (1, 2), (2, 3), (3, 0)]
    A = g.GrB_Matrix_new(g.GrB_BOOL, n, n, **device_kw)
    A = g.GrB_Matrix_build(A, [e[0] for e in ring],
                           [e[1] for e in ring], [True] * 4)
    v = g.GrB_Vector_new(g.GrB_INT32, n, **device_kw)
    v = g.GrB_assign(v, None, None, 0, g.GrB_ALL, None)
    q = g.GrB_Vector_new(g.GrB_BOOL, n, **device_kw)
    q = g.GrB_Vector_setElement(q, True, 0)
    Lor = g.GrB_Monoid_new(g.GrB_LOR, False)
    Boolean = g.GrB_Semiring_new(Lor, g.GrB_LAND)
    desc = g.GrB_Descriptor_new()
    desc = g.GrB_Descriptor_set(desc, g.GrB_MASK, g.GrB_SCMP)
    desc = g.GrB_Descriptor_set(desc, g.GrB_OUTP, g.GrB_REPLACE)
    level = 1
    while True:
        v = g.GrB_assign(v, q, None, level, g.GrB_ALL, None)
        q = g.GrB_vxm(q, v, None, Boolean, q, A, desc)
        if not g.GrB_reduce(None, Lor, q):
            break
        level += 1
    return np.where(v.pattern_np(), v.to_dense(), 0).tolist()


def test_reference_style_bfs_fragment():
    lev = _bfs_levels(grb, {"device": DEV})
    assert lev == [1, 2, 3, 4]
    assert lev == _bfs_levels(jgrb, {})


def test_descriptor_axb_method_hint():
    A = grb.GrB_Matrix_new(grb.GrB_FP64, 2, 2, device=DEV)
    A = grb.GrB_Matrix_build(A, [0, 1], [1, 0], [2.0, 3.0])
    Aj = jgrb.GrB_Matrix_build(jgrb.GrB_Matrix_new(jgrb.GrB_FP64, 2, 2),
                               [0, 1], [1, 0], [2.0, 3.0])
    d = grb.GrB_Descriptor_set(grb.GrB_Descriptor_new(),
                               grb.GxB_AxB_METHOD, grb.GxB_AxB_GUSTAVSON)
    dj = jgrb.GrB_Descriptor_set(jgrb.GrB_Descriptor_new(),
                                 jgrb.GxB_AxB_METHOD, jgrb.GxB_AxB_GUSTAVSON)
    C = grb.GrB_mxm(grb.GrB_Matrix_new(grb.GrB_FP64, 2, 2, device=DEV),
                    None, None, grb.GxB_PLUS_TIMES_FP64, A, A, d)
    jgrb.GrB_mxm(jgrb.GrB_Matrix_new(jgrb.GrB_FP64, 2, 2), None, None,
                 jgrb.GxB_PLUS_TIMES_FP64, Aj, Aj, dj)
    assert jax_last_method() == "vpu:generic"
    assert jax_engine_name(last_axb_method()) == "vpu:generic"
    C2 = grb.GrB_mxm(grb.GrB_Matrix_new(grb.GrB_FP64, 2, 2, device=DEV),
                     None, None, grb.GxB_PLUS_TIMES_FP64, A, A, None)
    jgrb.GrB_mxm(jgrb.GrB_Matrix_new(jgrb.GrB_FP64, 2, 2), None, None,
                 jgrb.GxB_PLUS_TIMES_FP64, Aj, Aj, None)
    assert jax_last_method() == "mxu:plus_times"
    assert jax_engine_name(last_axb_method()) == "mxu:plus_times"
    assert np.allclose(C.to_dense(), C2.to_dense())


def test_flopcount_and_select():
    rng = np.random.default_rng(0)
    Ap = rng.random((20, 30)) < 0.2
    Bp = rng.random((30, 10)) < 0.2
    fl = axb_flopcount(Ap, Bp)
    want = sum(int(Ap[:, k].sum()) * int(Bp[k].sum()) for k in range(30))
    assert fl == want
    assert choose_axb_method(1000, 1000, 1000, 5000, 5000) == "dense-mxu"
    # bitmap-scale product with a sparse mask -> bitpack wins
    m = choose_axb_method(10000, 10000, 10000, 10**6, 10**6,
                          mnnz=10**4)
    assert m == "bitpack"
    # bitmap-scale banded structure -> bsr wins
    m = choose_axb_method(10000, 10000, 10000, 10**6, 10**6,
                          mnnz=None, ntile_triples=3000)
    assert m == "bsr"
    # past bitmap scale the dense engines are infeasible: ESC takes over
    m = choose_axb_method(100000, 100000, 100000, 10**6, 10**6,
                          mnnz=10**5)
    assert m == "esc"


def test_import_export_names():
    A = grb.GrB_Matrix_new(grb.GrB_FP64, 2, 3, device=DEV)
    A = grb.GrB_Matrix_build(A, [0, 1], [2, 0], [5.0, 7.0])
    nr, nc, p, j, x = grb.GxB_Matrix_export_CSR(A)
    B = grb.GxB_Matrix_import_CSR(nr, nc, p, j, x, grb.GrB_FP64, device=DEV)
    assert np.allclose(B.to_matrix().to_dense(), A.to_dense())


def test_wait_and_nonblocking():
    v = grb.GrB_Vector_new(grb.GrB_FP64, 4, device=DEV)
    v = v.setElement(2.5, 1, blocking=False)
    assert v._pending
    v = grb.GrB_wait(v)
    assert not v._pending
    assert grb.GrB_Vector_extractElement(v, 1) == 2.5


# ---------------------------------------------------------------------------
# facade review regressions
# ---------------------------------------------------------------------------

def test_grb_wait_single_returns_object():
    v = grb.GrB_Vector_new(grb.GrB_FP64, 3, device=DEV)
    v = v.setElement(1.0, 0, blocking=False)
    v = grb.GrB_wait(v)          # NOT a tuple
    assert grb.GrB_Vector_extractElement(v, 0) == 1.0
    a, b = grb.GrB_wait(v, v)    # multiple -> tuple
    assert grb.GrB_Vector_nvals(a) == 1
    assert grb.GrB_wait() == 0


def test_descriptor_reset_to_default():
    d = grb.GrB_Descriptor_set(grb.GrB_Descriptor_new(),
                               grb.GrB_OUTP, grb.GrB_REPLACE)
    assert d.replace
    d = grb.GrB_Descriptor_set(d, grb.GrB_OUTP, grb.GxB_DEFAULT)
    assert not d.replace
    with pytest.raises(ValueError):
        grb.GrB_Descriptor_set(d, "nope", grb.GrB_TRAN)
    with pytest.raises(ValueError):
        grb.GrB_Descriptor_set(d, grb.GrB_OUTP, grb.GrB_TRAN)


def test_gxb_set_global_form():
    grb.GxB_set("format", "by_col")
    assert grb.GxB_get("format") == "by_col"
    grb.GxB_set("format", "by_row")
    d = grb.GxB_set(grb.GrB_Descriptor_new(), grb.GrB_INP1, grb.GrB_TRAN)
    assert grb.GxB_get(d, grb.GrB_INP1) is True


def test_subassign_col_vector_form():
    outs = []
    for g, kw in ((grb, {"device": DEV}), (jgrb, {})):
        C = g.GrB_Matrix_new(g.GrB_FP64, 4, 3, **kw)
        u = g.GrB_Vector_new(g.GrB_FP64, 2, **kw)
        u = u.setElement(5.0, 0).setElement(7.0, 1)
        # C(I, 1) = u  (GxB_Col_subassign form)
        C2 = g.GxB_subassign(C, None, None, u, [0, 2], 1)
        assert C2.extractElement(0, 1) == 5.0
        assert C2.extractElement(2, 1) == 7.0
        # C(1, J) = u'  (GxB_Row_subassign form)
        C3 = g.GxB_subassign(C, None, None, u, 1, [0, 2])
        assert C3.extractElement(1, 0) == 5.0
        assert C3.extractElement(1, 2) == 7.0
        outs.append([np.asarray(x) for X in (C2, C3)
                     for x in X.extractTuples()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["matrix", "vector", "row", "col",
                                  "scalar", "vector_scalar"])
def test_polymorphic_assign_extract_match_jax(form):
    """GrB_assign / GrB_extract dispatch on their argument types as the
    JAX facade does, with equal results."""
    rng = np.random.default_rng(31)
    dense = np.round(rng.normal(size=(5, 6)), 3)
    mask = rng.random((5, 6)) < 0.6
    outs = []
    for g, kw in ((grb, {"device": DEV}), (jgrb, {})):
        I, J = np.nonzero(mask)
        A = g.GrB_Matrix_build(g.GrB_Matrix_new(g.GrB_FP64, 5, 6, **kw),
                               I, J, dense[I, J])
        u = g.GrB_Vector_build(g.GrB_Vector_new(g.GrB_FP64, 3, **kw),
                               [0, 2], [1.5, -2.0])
        if form == "matrix":
            S = g.GrB_extract(g.GrB_Matrix_new(g.GrB_FP64, 2, 3, **kw),
                              None, None, A, [1, 3], [0, 2, 4])
            out = g.GrB_assign(A, None, g.GrB_PLUS_FP64, S, [0, 4],
                               [1, 3, 5])
        elif form == "vector":
            w = g.GrB_extract(g.GrB_Vector_new(g.GrB_FP64, 3, **kw), None,
                              None, A, [0, 2, 4], 3)
            out = g.GrB_assign(w, None, None, u, g.GrB_ALL)
        elif form == "row":
            out = g.GrB_assign(A, None, None, u, 2, [0, 1, 5])
        elif form == "col":
            out = g.GrB_assign(A, None, None, u, [0, 1, 4], 2)
        elif form == "scalar":
            out = g.GrB_assign(A, None, None, 9.5, [1, 2], [2, 3])
        else:
            out = g.GxB_subassign(u, None, None, 4.0, [1])
        outs.append([np.asarray(x) for x in out.extractTuples()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_operator_constructors_and_options():
    import torch
    op = grb.GrB_BinaryOp_new(lambda x, y: x * y + 1, grb.GrB_FP64,
                              grb.GrB_FP64, grb.GrB_FP64, name="fma1")
    assert op.name == "FMA1"
    un = grb.GrB_UnaryOp_new(lambda x: -x, grb.GrB_FP64, grb.GrB_FP64)
    mon = grb.GxB_Monoid_terminal_new(grb.GrB_MAX_FP64, -np.inf, np.inf)
    sr = grb.GrB_Semiring_new(mon, op)
    sel = grb.GxB_SelectOp_new(lambda i, j, x, k: i == j, name="diag2")
    x = torch.tensor([2.0, 3.0], dtype=torch.float64)
    assert op(x, x).tolist() == [5.0, 10.0]
    assert un(x).tolist() == [-2.0, -3.0]
    assert sr.add.terminal == np.inf and sel.name == "DIAG2"
    with pytest.raises(TypeError):
        grb.GrB_Type_new(16)
    T = grb.GrB_Type_new({"a": grb.GrB_FP64})
    assert T.is_udt
    A = grb.GrB_Matrix_new(grb.GrB_FP64, 2, 2, device=DEV)
    assert grb.GxB_Matrix_Option_set(A, "hyper_ratio", 0.5) == \
        grb.GrB_init()
    assert grb.GxB_Matrix_Option_get(A, "hyper_ratio") == 0.5
    grb.GxB_Global_Option_set("hyper_ratio", 0.125)
    assert grb.GxB_Global_Option_get("hyper_ratio") == 0.125
    grb.GrB_init()
