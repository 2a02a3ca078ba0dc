"""PyTorch port, the ESC engine (``sparse/esc.py``) and the segment
reductions (``sparse/spmv.py``): parity with the JAX package.

The same CSR operands, built from numpy tuples made from a seed, go
through ``graphblas_tpu.sparse.esc.csr_spgemm`` and the port's.  Output
patterns and integer/bool values must be equal exactly; float values
within rtol=2e-5, atol=2e-6 (the reassociation tolerance of
``tests/test_valdot.py``: the sums are taken in another order).  Mirrors
``test_esc``."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core import monoids as jmon
from graphblas_tpu.core import ops as jops
from graphblas_tpu.core import semirings as jsr
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import esc as jesc
from graphblas_tpu.sparse import spmv as jspmv
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.core import monoids as tmon
from graphblas_tpu_torch.core import ops as tops
from graphblas_tpu_torch.core import semirings as tsr
from graphblas_tpu_torch.sparse import esc as tesc
from graphblas_tpu_torch.sparse import spmv as tspmv
from graphblas_tpu_torch.utils import counters


def _tuples(rng, m, n, density, tname):
    nnz = int(m * n * density)
    lin = np.unique(rng.integers(0, m * n, nnz))
    I, J = lin // n, lin % n
    dt = np.dtype(getattr(gb, tname).dtype)
    if dt == np.bool_:
        X = rng.random(len(I)) < 0.7
    elif np.issubdtype(dt, np.integer):
        X = rng.integers(0 if np.iinfo(dt).min == 0 else -4, 9,
                         len(I)).astype(dt)
    else:
        X = (rng.random(len(I)) * 4 - 2).astype(dt)
    return I, J, X


def both(I, J, X, m, n, tname):
    """(JAX CsrMatrix, port CsrMatrix) of the same tuples."""
    Aj = jsp.CsrMatrix.from_coo(I, J, X, m, n, type=getattr(gb, tname),
                                sum_duplicates=False)
    return Aj, convert.from_jax(Aj, device="cpu")


def tuples_of(C):
    I, J, X = C.extractTuples()
    o = np.lexsort((np.asarray(J), np.asarray(I)))
    return np.asarray(I)[o], np.asarray(J)[o], np.asarray(X)[o]


def assert_same_csr(Ct, Cj, exact=None):
    ti, tj, tx = tuples_of(Ct)
    ji, jj, jx = tuples_of(Cj)
    assert Ct.nvals == Cj.nvals and Ct.shape == Cj.shape
    assert np.array_equal(ti, ji) and np.array_equal(tj, jj), "pattern"
    assert tx.dtype == jx.dtype
    if exact is None:
        exact = not np.issubdtype(tx.dtype, np.floating)
    if exact:
        assert np.array_equal(tx, jx)
    else:
        np.testing.assert_allclose(tx, jx, rtol=2e-5, atol=2e-6,
                                   equal_nan=True)


FAMILIES = [
    ("plus", "times", "FP32"),
    ("plus", "times", "FP64"),
    ("plus", "times", "INT32"),
    ("plus", "times", "UINT8"),      # wraps mod 256
    ("min", "plus", "FP64"),
    ("max", "second", "INT64"),
    ("lor", "land", "BOOL"),
    ("land", "lor", "BOOL"),
    ("lxor", "land", "BOOL"),
    ("times", "times", "FP32"),
    ("plus", "pair", "INT32"),
    ("min", "first", "INT32"),
    ("plus", "minus", "FP64"),       # non-commutative mult: operand order
    ("min", "div", "FP64"),
    ("eq", "eq", "BOOL"),
    ("max", "min", "UINT32"),
]


@pytest.mark.parametrize("addname,multname,tname", FAMILIES,
                         ids=[f"{a}_{m}_{t}" for a, m, t in FAMILIES])
def test_esc_matches_jax(addname, multname, tname):
    rng = np.random.default_rng(
        zlib.crc32(f"{addname}{multname}{tname}".encode()))
    Aj, At = both(*_tuples(rng, 17, 23, 0.3, tname), 17, 23, tname)
    Bj, Bt = both(*_tuples(rng, 23, 19, 0.3, tname), 23, 19, tname)
    srj = jsr.semiring[f"{addname}_{multname}"][getattr(gb, tname)]
    srt = convert.from_jax(srj)
    Cj = jesc.csr_spgemm(srj, Aj, Bj)
    Ct = tesc.csr_spgemm(srt, At, Bt)
    assert gt.last_axb_method() == jax_last_method() == "esc:csr_spgemm"
    assert_same_csr(Ct, Cj)
    assert Ct.nzmax == Cj.nzmax


@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("tname", ["FP64", "INT32", "BOOL"])
def test_esc_masked_matches_jax(tname, complement):
    rng = np.random.default_rng(5)
    Aj, At = both(*_tuples(rng, 20, 20, 0.25, tname), 20, 20, tname)
    Bj, Bt = both(*_tuples(rng, 20, 20, 0.25, tname), 20, 20, tname)
    Mj, Mt = both(*_tuples(rng, 20, 20, 0.4, tname), 20, 20, tname)
    srj = jsr.semiring.plus_times[getattr(gb, tname)] \
        if tname != "BOOL" else jsr.semiring.lor_land[gb.BOOL]
    srt = convert.from_jax(srj)
    Cj = jesc.csr_spgemm(srj, Aj, Bj, mask=Mj, complement=complement)
    Ct = tesc.csr_spgemm(srt, At, Bt, mask=Mt, complement=complement)
    assert_same_csr(Ct, Cj)
    for structural in (False, True):
        Cj = jesc.csr_spgemm(srj, Aj, Bj, mask=Mj, complement=complement,
                             structural=structural)
        Ct = tesc.csr_spgemm(srt, At, Bt, mask=Mt, complement=complement,
                             structural=structural)
        assert_same_csr(Ct, Cj)


def test_esc_valued_mask_zeros():
    """Mask entries with value 0 do NOT select (valued-mask semantics)."""
    rng = np.random.default_rng(8)
    Aj, At = both(*_tuples(rng, 10, 10, 0.5, "INT32"), 10, 10, "INT32")
    Bj, Bt = both(*_tuples(rng, 10, 10, 0.5, "INT32"), 10, 10, "INT32")
    I, J, X = _tuples(rng, 10, 10, 0.6, "INT32")
    X[np.arange(len(X)) % 3 == 0] = 0
    Mj, Mt = both(I, J, X, 10, 10, "INT32")
    srj = jsr.semiring.plus_times[gb.INT32]
    Cj = jesc.csr_spgemm(srj, Aj, Bj, mask=Mj)
    Ct = tesc.csr_spgemm(convert.from_jax(srj), At, Bt, mask=Mt)
    assert_same_csr(Ct, Cj)
    keys = set(zip(*tuples_of(Ct)[:2]))
    zero = {(i, j) for i, j, x in zip(I, J, X) if x == 0}
    assert not keys & zero


#: masks against the product's lanes: (m, k, n, density of A, of B, of
#: M, extra padded mask slots, share of mask values set to 0, mask rows
#: only past A's rows, lane cap of both packages or None)
MASK_CASES = {
    "padded_zeros": (20, 20, 20, 0.25, 0.25, 0.4, 300, 0.3, False, None),
    "long_mask": (40, 40, 40, 0.02, 0.02, 0.9, 0, 0.0, False, None),
    "short_mask": (30, 30, 30, 0.3, 0.3, 0.01, 0, 0.0, False, None),
    "all_masked_out": (24, 24, 24, 0.3, 0.3, 0.5, 0, 0.0, True, None),
    "chunked_padded_zeros": (40, 40, 40, 0.15, 0.15, 0.3, 300, 0.3, False,
                             1 << 9),
}


def _mask_case(case):
    """(JAX A, B, M, port A, B, M) of one case of ``MASK_CASES``."""
    m, k, n, da, db, dm, extra, zeros, past, _ = MASK_CASES[case]
    rng = np.random.default_rng(sorted(MASK_CASES).index(case) + 40)
    I, J, X = _tuples(rng, m, k, da, "FP32")
    if past:                         # A only in the upper half of rows
        keep = I < m // 2
        I, J, X = I[keep], J[keep], X[keep]
    Aj, At = both(I, J, X, m, k, "FP32")
    Bj, Bt = both(*_tuples(rng, k, n, db, "FP32"), k, n, "FP32")
    I, J, X = _tuples(rng, m, n, dm, "FP32")
    if past:                         # the mask only in the lower half
        keep = I >= m // 2
        I, J, X = I[keep], J[keep], X[keep]
    X[rng.random(len(X)) < zeros] = 0
    Mj = jsp.CsrMatrix.from_coo(I, J, X, m, n, type=gb.FP32,
                                nzmax=(len(I) + extra) if extra else None,
                                sum_duplicates=False)
    return Aj, Bj, Mj, At, Bt, convert.from_jax(Mj, device="cpu")


@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_esc_mask_membership_matches_jax(monkeypatch, case, complement,
                                         structural):
    """Membership searched in the mask's stored keys gives the JAX
    package's merged-sort answer: a padded mask with valued zeros, masks
    far longer and far shorter than the product's lanes, a product the
    mask removes whole, and the chunked path, each plain, complemented
    and structural."""
    Aj, Bj, Mj, At, Bt, Mt = _mask_case(case)
    cap = MASK_CASES[case][-1]
    if cap is not None:
        monkeypatch.setattr(tesc, "_ESC_LANE_CAP", cap)
        monkeypatch.setattr(jesc, "_ESC_LANE_CAP", cap)
    if MASK_CASES[case][6]:
        assert Mt.nvals < Mt.nzmax
    srj = jsr.semiring.plus_times[gb.FP32]
    Cj = jesc.csr_spgemm(srj, Aj, Bj, mask=Mj, complement=complement,
                         structural=structural)
    Ct = tesc.csr_spgemm(convert.from_jax(srj), At, Bt, mask=Mt,
                         complement=complement, structural=structural)
    assert gt.last_axb_method() == jax_last_method()
    if cap is not None:
        assert gt.last_axb_method() == "esc:chunked"
        assert len(At._options["_spgemm_chunks"][2]) > 1
    if case == "all_masked_out" and not complement:
        assert Ct.nvals == 0
    assert_same_csr(Ct, Cj)
    ip = Ct.indptr.numpy()
    assert ip[0] == 0 and ip[-1] == Ct.nvals and np.all(np.diff(ip) >= 0)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("complement", [False, True])
def test_esc_sorted_lanes_are_the_products_lanes(monkeypatch, complement,
                                                 chunked):
    """``esc.sorted_lanes`` counts the product's lanes alone, summed over
    the blocks of the chunked path: the mask, here longer than the
    product, adds none of its keys to the sort."""
    rng = np.random.default_rng(21)
    n = 60
    _, At = both(*_tuples(rng, n, n, 0.08, "FP32"), n, n, "FP32")
    _, Bt = both(*_tuples(rng, n, n, 0.08, "FP32"), n, n, "FP32")
    _, Mt = both(*_tuples(rng, n, n, 0.8, "FP32"), n, n, "FP32")
    hpA, hpB = At._options["host_pattern"], Bt._options["host_pattern"]
    lanes = int(np.bincount(hpB[0][:Bt.nvals], minlength=n + 1)[
        hpA[1][:At.nvals]].sum())
    assert 0 < lanes < Mt.nvals
    if chunked:
        monkeypatch.setattr(tesc, "_ESC_LANE_CAP", lanes // 4)
    counters.reset()
    tesc.csr_spgemm(gt.semiring.plus_times[gt.FP32], At, Bt, mask=Mt,
                    complement=complement)
    assert gt.last_axb_method() == ("esc:chunked" if chunked
                                    else "esc:csr_spgemm")
    assert counters.stats()["counts"]["esc.sorted_lanes"] == lanes


#: compacted keys of a 4 x 5 output (sentinel 20: row 4, column 5)
ASSEMBLE_CASES = {
    "sentinel_tail": [1, 3, 6, 12, 13, 19, 20, 20, 20],
    "all_sentinel": [20, 20, 20, 20],
    "empty": [],
    "one_full_row": [5, 6, 7, 8, 9, 20, 20],
    "last_row_full": [0, 15, 16, 17, 18, 19, 20],
}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(ASSEMBLE_CASES))
def test_assemble_indptr_matches_bincount(case, dtype):
    """The row pointers searched in the ascending row ids equal a
    ``bincount`` of them; indices and row ids take the sentinel's (4, 5)
    at the tail."""
    m, n = 4, 5
    keys = np.asarray(ASSEMBLE_CASES[case], np.int64)
    indptr, oj, oi = tesc._assemble(torch.tensor(keys, dtype=dtype),
                                    m * n, m, n)
    live = keys[keys < m * n]
    want = np.zeros(m + 1, np.int64)
    want[1:] = np.cumsum(np.bincount(live // n, minlength=m))
    assert indptr.dtype == torch.int32
    assert np.array_equal(indptr.numpy(), want)
    sent = keys == m * n
    assert np.array_equal(oi.numpy(), np.where(sent, m, keys // n))
    assert np.array_equal(oj.numpy(), np.where(sent, n, keys % n))


def test_esc_empty_and_shapes():
    rng = np.random.default_rng(9)
    srt = gt.semiring.plus_times[gt.FP32]
    e = np.zeros(0, np.int64)
    At = gt.csr_from_coo(e, e, np.zeros(0, np.float32), 5, 7, device="cpu")
    _, Bt = both(*_tuples(rng, 7, 3, 0.5, "FP32"), 7, 3, "FP32")
    C = tesc.csr_spgemm(srt, At, Bt)
    assert C.nvals == 0 and C.shape == (5, 3) and C.type is gt.FP32
    with pytest.raises(gt.DimensionMismatch):
        tesc.csr_spgemm(srt, Bt, Bt)
    Mt = gt.csr_from_coo(e, e, np.zeros(0, np.float32), 5, 3, device="cpu")
    _, A2 = both(*_tuples(rng, 5, 7, 0.5, "FP32"), 5, 7, "FP32")
    assert tesc.csr_spgemm(srt, A2, Bt, mask=Mt).nvals == 0
    Cc = tesc.csr_spgemm(srt, A2, Bt, mask=Mt, complement=True)
    assert Cc.nvals == tesc.csr_spgemm(srt, A2, Bt).nvals


def test_esc_user_monoid_scan_path():
    """A user-defined add monoid exercises the segmented-scan fold."""
    rng = np.random.default_rng(12)
    absmax_j = jops.BinaryOp("ABSMAX", lambda x, y: jnp.where(
        jnp.abs(x) >= jnp.abs(y), x, y), gb.FP64, gb.FP64, gb.FP64)
    absmax_t = tops.BinaryOp("ABSMAX", lambda x, y: torch.where(
        x.abs() >= y.abs(), x, y), gt.FP64, gt.FP64, gt.FP64)
    srj = jsr.Semiring(jmon.monoid_new(absmax_j, 0.0),
                       jops.binary.times[gb.FP64])
    srt = tsr.Semiring(tmon.monoid_new(absmax_t, 0.0),
                       tops.binary.times[gt.FP64])
    Aj, At = both(*_tuples(rng, 12, 15, 0.4, "FP64"), 12, 15, "FP64")
    Bj, Bt = both(*_tuples(rng, 15, 9, 0.4, "FP64"), 15, 9, "FP64")
    assert_same_csr(tesc.csr_spgemm(srt, At, Bt),
                    jesc.csr_spgemm(srj, Aj, Bj), exact=True)


def test_esc_int64_keys():
    """Dimensions past the 2^31 linear-key range switch to int64 keys."""
    n = 70_000
    I = np.array([0, 1, 2, n - 1])
    J = np.array([1, 2, 3, 0])
    X = np.array([1.0, 2.0, 3.0, 4.0])
    Aj, At = both(I, J, X, n, n, "FP64")
    srj = jsr.semiring.plus_times[gb.FP64]
    Ct = tesc.csr_spgemm(convert.from_jax(srj), At, At)
    assert_same_csr(Ct, jesc.csr_spgemm(srj, Aj, Aj), exact=True)
    Ic, Jc, Xc = Ct.extractTuples()
    got = {(int(i), int(j)): x for i, j, x in zip(Ic, Jc, Xc)}
    assert got == {(0, 2): 2.0, (1, 3): 6.0, (n - 1, 1): 4.0}
    Mt = gt.csr_from_coo([0, n - 1], [2, 1], np.ones(2), n, n,
                         device="cpu")
    Cm = tesc.csr_spgemm(convert.from_jax(srj), At, At, mask=Mt)
    assert Cm.nvals == 2


def test_esc_plan_cache_repeated_calls():
    rng = np.random.default_rng(13)
    n = 300
    _, At = both(*_tuples(rng, n, n, 0.02, "FP64"), n, n, "FP64")
    _, Bt = both(*_tuples(rng, n, n, 0.02, "FP64"), n, n, "FP64")
    sr = gt.semiring.plus_times[gt.FP64]
    C1 = tesc.csr_spgemm(sr, At, Bt)
    plan = At._options[("_spgemm_plan", False, False)]
    C2 = tesc.csr_spgemm(sr, At, Bt)          # plan hit
    assert At._options[("_spgemm_plan", False, False)] is plan
    for a, b in zip(C1.extractTuples(), C2.extractTuples()):
        assert np.array_equal(a, b)
    _, B2 = both(*_tuples(rng, n, n, 0.005, "FP64"), n, n, "FP64")
    C3 = tesc.csr_spgemm(sr, At, B2)          # another B: a fresh plan
    assert C3.nvals != C1.nvals


def test_esc_plan_cache_valued_mask_invalidation():
    """A valued mask keys output nnz on its VALUES: same pattern with
    other values must not reuse the cached nnz."""
    rng = np.random.default_rng(14)
    n = 200
    I, J, X = _tuples(rng, n, n, 0.04, "FP64")
    _, At = both(I, J, X, n, n, "FP64")
    _, Bt = both(*_tuples(rng, n, n, 0.04, "FP64"), n, n, "FP64")
    sr = gt.semiring.plus_times[gt.FP64]
    _, M1 = both(I, J, np.ones(len(I)), n, n, "FP64")
    C1 = tesc.csr_spgemm(sr, At, Bt, mask=M1)
    newv = M1.values.clone()
    newv[:M1.nvals // 2] = 0.0
    M2 = gt.CsrMatrix(M1.indptr, M1.indices, M1.rowids, newv, M1.nvals,
                      n, n, gt.FP64)
    C2 = tesc.csr_spgemm(sr, At, Bt, mask=M2)
    assert C2.nvals < C1.nvals


@pytest.mark.parametrize("host_pattern", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_matches_single_program(monkeypatch, masked, host_pattern):
    """Flop totals beyond the lane cap split into A-entry blocks whose
    partials monoid-merge to the same result (cap patched in both
    packages).  Operands with and without a host pattern take one path:
    the same reads, one of them the blocks' cumulative lane count."""
    r = np.random.default_rng(99)
    n = 400
    I, J, _ = _tuples(r, n, n, 6000 / n / n, "FP32")
    va = (r.random(len(I)) * 3 - 1).astype(np.float32)
    Aj, At = both(I, J, va, n, n, "FP32")
    Bv = (r.random(len(I)) * 2 + 1).astype(np.float32)
    order = np.lexsort((I, J))
    Bj, Bt = both(J[order], I[order], Bv[order], n, n, "FP32")
    Mj, Mt = both(*_tuples(r, n, n, 3000 / n / n, "FP32"), n, n, "FP32")
    mj, mt = (Mj, Mt) if masked else (None, None)
    srj = jsr.semiring.plus_times[gb.FP32]
    srt = gt.semiring.plus_times[gt.FP32]
    single = tesc.csr_spgemm(srt, At, Bt, mask=mt)
    monkeypatch.setattr(tesc, "_ESC_LANE_CAP", 1 << 14)
    monkeypatch.setattr(jesc, "_ESC_LANE_CAP", 1 << 14)
    A2j, A2t = both(I, J, va, n, n, "FP32")
    if not host_pattern:
        del A2t._options["host_pattern"], Bt._options["host_pattern"]
    counters.reset()
    counters.trace_spans(True)
    try:
        got = tesc.csr_spgemm(srt, A2t, Bt, mask=mt)
    finally:
        counters.trace_spans(False)
    assert gt.last_axb_method() == "esc:chunked"
    nb = len(A2t._options["_spgemm_chunks"][2])
    assert nb > 1
    assert {name: sp["count"] for name, sp in counters.stats()[
        "spans"].items() if name.startswith("gb.read.")} == {
        "gb.read.esc_flops": 1 + nb, "gb.read.esc_block_lanes": 1,
        "gb.read.esc_nnz": nb, "gb.read.esc_merge_nnz": nb - 1}
    want = jesc.csr_spgemm(srj, A2j, Bj, mask=mj)
    assert jax_last_method() == "esc:chunked"
    assert_same_csr(got, want)
    gi, gj, gx = tuples_of(got)
    si, sj, sx = tuples_of(single)
    assert np.array_equal(gi, si) and np.array_equal(gj, sj)
    np.testing.assert_allclose(gx, sx, rtol=1e-5)


def test_esc_large_dimension_no_densify():
    """n = 200,000: a dense bitmap would need 40 GB; the O(nnz) path."""
    rng = np.random.default_rng(15)
    n = 200_000
    I = rng.integers(0, n, 4000)
    J = rng.integers(0, n, 4000)
    X = rng.random(4000).astype(np.float32)
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.FP32)
    At = convert.from_jax(Aj, device="cpu")
    srj = jsr.semiring.plus_times[gb.FP32]
    assert_same_csr(tesc.csr_spgemm(convert.from_jax(srj), At, At),
                    jesc.csr_spgemm(srj, Aj, Aj))


SEG_CASES = [("PLUS", "FP32"), ("PLUS", "INT32"), ("TIMES", "INT64"),
             ("MIN", "FP64"), ("MAX", "INT32"), ("LOR", "BOOL"),
             ("LAND", "BOOL"), ("LXOR", "BOOL"), ("EQ", "BOOL"),
             ("MAX", "UINT32"), ("MIN", "UINT8")]


@pytest.mark.parametrize("name,tname", SEG_CASES)
def test_segment_reduce_matches_jax(name, tname):
    rng = np.random.default_rng(16)
    E, nseg = 300, 40
    seg = np.sort(rng.integers(0, nseg - 3, E)).astype(np.int32)
    _, _, vals = _tuples(rng, 1, 4 * E, 1.0, tname)
    vals = vals[:E]
    t = getattr(gt, tname)
    mon = tmon.monoid[name.lower()][t]
    want = np.asarray(jspmv.segment_reduce(
        name, jnp.asarray(vals), jnp.asarray(seg), nseg, mon.identity))
    got = tspmv.segment_reduce(name, torch.from_numpy(t.to_storage(vals)),
                               torch.from_numpy(seg), nseg,
                               mon.identity_value(), t).numpy()
    if t.is_unsigned:
        got = got.view(t.dtype)
    live = np.isin(np.arange(nseg), seg)        # JAX fills empty
    if tname.startswith("FP"):                  # segments otherwise
        np.testing.assert_allclose(got[live], want[live], rtol=2e-5,
                                   atol=2e-6)
    else:
        assert np.array_equal(got[live], want[live])


def test_segment_reduce_sorted_matches_jax():
    rng = np.random.default_rng(17)
    E, nseg = 500, 60
    seg = np.sort(rng.integers(0, nseg, E)).astype(np.int32)
    vals = rng.normal(size=E)
    want = np.asarray(jspmv.segment_reduce_sorted(
        lambda a, b: jnp.where(jnp.abs(a) >= jnp.abs(b), a, b), 0.0,
        jnp.asarray(vals), jnp.asarray(seg), nseg))
    got = tspmv.segment_reduce_sorted(
        lambda a, b: torch.where(a.abs() >= b.abs(), a, b), 0.0,
        torch.from_numpy(vals), torch.from_numpy(seg), nseg).numpy()
    assert np.array_equal(got, want)
