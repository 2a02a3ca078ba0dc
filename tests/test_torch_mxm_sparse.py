"""PyTorch port, ``mxm`` on CSR outputs: engine choice, the small dense
branch (``semiring_mm``), ESC, valdot and the sparse accum/mask epilogue,
in parity with the JAX package's ``gb.mxm``.

The same CSR operands (numpy tuples from a seed) go through both
packages' ``mxm``; output patterns and integer values must be equal
exactly, float values within rtol=2e-5, atol=2e-6 (reassociation).
Mirrors ``test_mxm_sparse`` and the mxm part of ``test_valdot``."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core.descriptor import Descriptor as JDescriptor
from graphblas_tpu.core.semirings import semiring as jsemiring
from graphblas_tpu.ops import flopcount as jfc
from graphblas_tpu.ops.mxm import mxm as jmxm
from graphblas_tpu.ops.mxm import semiring_mm as j_semiring_mm
from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.sparse.mask import csr_accum_mask as j_accum_mask
from graphblas_tpu.utils import counters as jcounters
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.ops import flopcount as tfc
from graphblas_tpu_torch.sparse import bitdot as tbd
from graphblas_tpu_torch.sparse.mask import csr_accum_mask
from graphblas_tpu_torch.utils import counters

from tests.test_torch_esc import _tuples, assert_same_csr, both, tuples_of
from tests.test_torch_valdot import _powerlaw


def rand_both(rng, m, n, density, tname="FP64"):
    return both(*_tuples(rng, m, n, density, tname), m, n, tname)


def empty_both(m, n, tname):
    e = np.zeros(0, np.int64)
    X = np.zeros(0, getattr(gb, tname).dtype)
    return both(e, e, X, m, n, tname)


def _desc(**kw):
    return JDescriptor(**kw), gt.Descriptor(**kw)


def test_choose_axb_regimes():
    # small dense-ish: the bitmap product engine
    assert tfc.choose_axb_method(512, 512, 512, 80_000, 80_000) == \
        "dense-mxu"
    # small + sparse mask: the bitpack dot engine
    assert tfc.choose_axb_method(8192, 8192, 8192, 100_000, 100_000,
                                 mnnz=50_000) == "bitpack"
    # small + clustered tiles: BSR
    assert tfc.choose_axb_method(8192, 8192, 8192, 500_000, 500_000,
                                 ntile_triples=40) == "bsr"
    # large dimension: dense infeasible -> ESC regardless
    assert tfc.choose_axb_method(1 << 20, 1 << 20, 1 << 20,
                                 1 << 22, 1 << 22) == "esc"
    assert tfc.choose_axb_method(1 << 20, 1 << 20, 1 << 20, 1 << 22,
                                 1 << 22, mnnz=1 << 20) == "esc"
    rng = np.random.default_rng(1)
    for _ in range(200):
        m, k, n = (int(x) for x in 2 ** rng.integers(3, 22, 3))
        a, b = (int(x) for x in rng.integers(1, 1 << 24, 2))
        kw = dict(mnnz=int(rng.integers(1, 1 << 22))
                  if rng.random() < 0.5 else None,
                  est_flops=int(rng.integers(1, 1 << 30))
                  if rng.random() < 0.5 else None)
        assert tfc.choose_axb_method(m, k, n, a, b, **kw) == \
            jfc.choose_axb_method(m, k, n, a, b, **kw)


def test_axb_flopcount_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.random((20, 30)) < 0.2
    B = rng.random((30, 25)) < 0.2
    M = rng.random((20, 25)) < 0.3
    assert tfc.axb_flopcount(A, B) == jfc.axb_flopcount(A, B)
    assert tfc.axb_flopcount(A, B, M) == jfc.axb_flopcount(A, B, M)


def test_mxm_csr_routes_to_esc():
    rng = np.random.default_rng(3)
    n, nnz = 100_000, 2000
    I, J = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    X = rng.random(nnz).astype(np.float32)
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.FP32)
    At = convert.from_jax(Aj, device="cpu")
    Ct = gt.mxm(gt.csr_clear(At), None, None,
                gt.semiring.plus_times[gt.FP32], At, At)
    assert isinstance(Ct, gt.CsrMatrix)
    assert gt.last_axb_method() == "esc:csr_spgemm"
    Cj = jmxm(jsp.csr_clear(Aj), None, None,
              jsemiring.plus_times[gb.FP32], Aj, Aj)
    assert_same_csr(Ct, Cj)


@pytest.mark.parametrize("srname,tname", [
    ("plus_times", "FP32"), ("plus_times", "INT32"), ("plus_pair", "INT32"),
    ("lor_land", "BOOL"), ("land_lor", "BOOL"), ("lxor_land", "BOOL"),
    ("min_plus", "FP64"), ("max_first", "INT32"), ("plus_second", "FP64"),
    ("plus_times", "UINT8")])
def test_mxm_csr_small_routes_dense(srname, tname):
    """Tiny + dense-ish: the cost model picks the bitmap product even for
    CSR containers (the output still comes back as a CsrMatrix)."""
    rng = np.random.default_rng(4)
    Aj, At = rand_both(rng, 40, 40, 0.5, tname)
    srj = jsemiring[srname][getattr(gb, tname)]
    srt = convert.from_jax(srj)
    Ct = gt.mxm(gt.csr_clear(At), None, None, srt, At, At)
    Cj = jmxm(jsp.csr_clear(Aj), None, None, srj, Aj, Aj)
    assert isinstance(Ct, gt.CsrMatrix)
    assert gt.last_axb_method() == jfc.last_axb_method()
    assert gt.last_axb_method().startswith(("mxu:", "vpu:"))
    assert_same_csr(Ct, Cj)


def _dense_vals(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) < 0.7
    if np.issubdtype(dtype, np.integer):
        lo = 0 if np.iinfo(dtype).min == 0 else -4
        return rng.integers(lo, 9, shape).astype(dtype)
    return (rng.random(shape) * 4 - 2).astype(dtype)


@pytest.mark.parametrize("hint", [None, "gustavson"])
def test_semiring_mm_matches_jax(hint):
    """The bitmap product on (values, pattern) pairs: the product route
    and the generic k-blocked route, for a spread of semirings."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    for srname, tname in (("plus_times", "FP32"), ("plus_times", "INT32"),
                          ("max_times", "FP64"), ("min_first", "INT32"),
                          ("lor_land", "BOOL"), ("plus_land", "INT32"),
                          ("times_plus", "INT32"), ("lxor_land", "BOOL"),
                          ("eq_eq", "BOOL"), ("max_min", "UINT32")):
        jt, tt = getattr(gb, tname), getattr(gt, tname)
        Ap = rng.random((9, 13)) < 0.5
        Bp = rng.random((13, 7)) < 0.5
        Av = np.where(Ap, _dense_vals(rng, (9, 13), jt.dtype), 0).astype(
            jt.dtype)
        Bv = np.where(Bp, _dense_vals(rng, (13, 7), jt.dtype), 0).astype(
            jt.dtype)
        srj = jsemiring[srname][jt]
        vj, pj, mj = j_semiring_mm(srj, jnp.asarray(Av), jnp.asarray(Ap),
                                   jnp.asarray(Bv), jnp.asarray(Bp),
                                   method_hint=hint)
        vt, pt, mt = gt.semiring_mm(
            convert.from_jax(srj), torch.from_numpy(tt.to_storage(Av)),
            torch.from_numpy(Ap), torch.from_numpy(tt.to_storage(Bv)),
            torch.from_numpy(Bp), method_hint=hint, atype=tt, btype=tt)
        assert mt == mj, (srname, mt, mj)
        assert np.array_equal(pt.numpy(), np.asarray(pj))
        zt = convert.from_jax(srj).ztype
        got = vt.numpy().view(zt.dtype) if zt.is_unsigned else vt.numpy()
        if zt.is_float:
            np.testing.assert_allclose(got, np.asarray(vj), rtol=2e-5,
                                       atol=2e-6)
        else:
            assert np.array_equal(got, np.asarray(vj)), srname


@pytest.mark.parametrize("accum_name", [None, "plus", "second", "max"])
@pytest.mark.parametrize("maskmode", ["none", "mask", "scmp"])
@pytest.mark.parametrize("replace", [False, True])
def test_mxm_csr_epilogue_sweep(accum_name, maskmode, replace):
    rng = np.random.default_rng(6)
    Aj, At = rand_both(rng, 15, 12, 0.35)
    Bj, Bt = rand_both(rng, 12, 18, 0.35)
    C0j, C0t = rand_both(rng, 15, 18, 0.3)
    Mj, Mt = rand_both(rng, 15, 18, 0.5) if maskmode != "none" \
        else (None, None)
    aj = gb.binary[accum_name][gb.FP64] if accum_name else None
    at = gt.binary[accum_name][gt.FP64] if accum_name else None
    dj, dt = _desc(replace=replace, mask_scmp=(maskmode == "scmp"))
    Cj = jmxm(C0j, Mj, aj, jsemiring.plus_times[gb.FP64], Aj, Bj, dj)
    Ct = gt.mxm(C0t, Mt, at, gt.semiring.plus_times[gt.FP64], At, Bt, dt)
    assert_same_csr(Ct, Cj)


@pytest.mark.parametrize("tran0,tran1", [(True, False), (False, True),
                                         (True, True)])
def test_mxm_csr_transposes(tran0, tran1):
    rng = np.random.default_rng(7)
    Aj, At = rand_both(rng, 14 if tran0 else 9, 9 if tran0 else 14, 0.4,
                       "FP32")
    Bj, Bt = rand_both(rng, 11 if tran1 else 14, 14 if tran1 else 11, 0.4,
                       "FP32")
    C0j, C0t = empty_both(9, 11, "FP32")
    dj, dt = _desc(tran0=tran0, tran1=tran1)
    Cj = jmxm(C0j, None, None, jsemiring.plus_times[gb.FP32], Aj, Bj, dj)
    Ct = gt.mxm(C0t, None, None, gt.semiring.plus_times[gt.FP32], At, Bt,
                dt)
    assert Ct.shape == (9, 11)
    assert_same_csr(Ct, Cj)


def test_csr_accum_mask_structural():
    """Structural masks select on pattern, ignoring explicit zeros."""
    rng = np.random.default_rng(8)
    C0j, C0t = rand_both(rng, 10, 10, 0.3, "INT32")
    Tj, Tt = rand_both(rng, 10, 10, 0.4, "INT32")
    I, J, _ = _tuples(rng, 10, 10, 0.5, "INT32")
    Mj, Mt = both(I, J, np.zeros(len(I), np.int32), 10, 10, "INT32")
    for structural in (True, False):
        dj, dt = _desc(mask_structure=structural)
        got = csr_accum_mask(C0t, Mt, Tt, None, dt)
        assert_same_csr(got, j_accum_mask(C0j, Mj, Tj, None, dj))
    got = csr_accum_mask(C0t, Mt, Tt, None, gt.Descriptor(
        mask_structure=True))
    keys = set(zip(*tuples_of(got)[:2]))
    tkeys = set(zip(*tuples_of(Tt)[:2]))
    assert {k for k in tkeys if k in set(zip(I, J))} <= keys


#: (mask density, extra padded mask slots, share of mask values 0)
EPILOGUE_MASKS = {"padded_zeros": (0.5, 200, 0.3),
                  "long_mask": (0.95, 0, 0.0),
                  "short_mask": (0.02, 300, 0.0)}


@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("scmp", [False, True])
@pytest.mark.parametrize("case", sorted(EPILOGUE_MASKS))
def test_csr_accum_mask_searches_stored_mask_keys(case, scmp, structural):
    """The epilogue's membership, searched in the mask's keys as stored
    (padding and valued zeros included, nothing sorted), gives the JAX
    package's answer, with and without accumulation and REPLACE."""
    dm, extra, zeros = EPILOGUE_MASKS[case]
    rng = np.random.default_rng(sorted(EPILOGUE_MASKS).index(case) + 30)
    C0j, C0t = rand_both(rng, 16, 14, 0.3, "INT32")
    Tj, Tt = rand_both(rng, 16, 14, 0.4, "INT32")
    I, J, X = _tuples(rng, 16, 14, dm, "INT32")
    X = np.where(rng.random(len(X)) < zeros, 0, X + 10).astype(np.int32)
    Mj = jsp.CsrMatrix.from_coo(I, J, X, 16, 14, type=gb.INT32,
                                nzmax=(len(I) + extra) if extra else None,
                                sum_duplicates=False)
    Mt = convert.from_jax(Mj, device="cpu")
    assert Mt.nzmax >= Mt.nvals + extra
    for accum, replace in ((None, False), ("plus", True)):
        dj, dt = _desc(mask_scmp=scmp, mask_structure=structural,
                       replace=replace)
        aj = gb.binary[accum][gb.INT32] if accum else None
        at = gt.binary[accum][gt.INT32] if accum else None
        got = csr_accum_mask(C0t, Mt, Tt, at, dt)
        assert_same_csr(got, j_accum_mask(C0j, Mj, Tj, aj, dj))
        ip = got.indptr.numpy()
        assert ip[0] == 0 and ip[-1] == got.nvals
        assert np.all(np.diff(ip) >= 0)


def test_mxm_csr_mixed_containers():
    """Bitmap Matrix inputs with a CSR C: inputs convert, output stays
    sparse."""
    rng = np.random.default_rng(9)
    Aj, At = rand_both(rng, 20, 20, 0.3, "FP32")
    C0j, C0t = empty_both(20, 20, "FP32")
    Ad = At.to_matrix()
    assert isinstance(Ad, gt.Matrix) and Ad.shape == (20, 20)
    assert int(Ad.pattern.sum()) == At.nvals
    Ct = gt.mxm(C0t, None, None, gt.semiring.plus_times[gt.FP32], Ad, Ad)
    assert isinstance(Ct, gt.CsrMatrix)
    Cj = jmxm(C0j, None, None, jsemiring.plus_times[gb.FP32], Aj, Aj)
    assert_same_csr(Ct, Cj)
    back = gt.CsrMatrix.from_matrix(Ad)
    assert_same_csr(back, Aj, exact=True)


def test_mxm_unported_paths_raise():
    rng = np.random.default_rng(10)
    _, At = rand_both(rng, 8, 8, 0.4, "FP32")
    # a bitmap C is supported since the fourth slice; a by-column C is not
    with pytest.raises(gt.UnsupportedContainer, match="CscMatrix"):
        gt.mxm(gt.CscMatrix.from_csr(At), None, None, "plus_times", At, At)
    with pytest.raises(gt.UnsupportedContainer):
        gt.mxm(At, None, None, "plus_times", np.eye(8), At)
    with pytest.raises(gt.UnsupportedOp):
        gt.mxm(At, None, None, "no_such_semiring", At, At)
    with pytest.raises(gt.DimensionMismatch):
        gt.mxm(gt.csr_clear(At), None, None, "plus_times", At,
               rand_both(rng, 5, 8, 0.4, "FP32")[1])


def test_public_mxm_routes_through_valdot(monkeypatch):
    """The masked CSR mxm auto-select tries valdot and records it (the
    graph is large enough that the small dense branch bows out); the
    gustavson hint bypasses valdot; both agree with the JAX package."""
    r = np.random.default_rng(55)
    I, J, n = _powerlaw(r, n=6000, mult=4)
    lo = I > J
    k = int(lo.sum())

    def v():
        return (r.random(k) * 4 - 2).astype(np.float32)
    Lj, Lt = both(I[lo], J[lo], v(), n, n, "FP32")
    Uj, Ut = both(J[lo], I[lo], v(), n, n, "FP32")
    Mj, Mt = both(I[lo], J[lo], v(), n, n, "FP32")
    C0j, C0t = empty_both(n, n, "FP32")
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    Ct = gt.mxm(C0t, Mt, None, "plus_times", Lt, Ut)
    assert gt.last_axb_method().startswith("valdot")
    Cj = jmxm(C0j, Mj, None, "plus_times", Lj, Uj)
    assert gt.last_axb_method() == jfc.last_axb_method()
    assert_same_csr(Ct, Cj)
    # the explicit gustavson hint must bypass valdot
    C2 = gt.mxm(C0t, Mt, None, "plus_times", Lt, Ut,
                gt.Descriptor(axb_method="gustavson"))
    assert gt.last_axb_method().startswith("esc")
    assert C2.nvals == Ct.nvals
    gi, gj, gx = tuples_of(Ct)
    ei, ej, ex = tuples_of(C2)
    assert np.array_equal(gi, ei) and np.array_equal(gj, ej)
    np.testing.assert_allclose(gx, ex, rtol=5e-5, atol=1e-4)


# -- the exact flop count, made on the device --------------------------------

#: (m, k, n, density of A, density of B, extra capacity, empty lines):
#: "empty lines" empties every third row and column of both operands
FLOP_CASES = {
    "square": (40, 40, 40, 0.15, 0.15, 0, False),
    "rectangular": (17, 33, 9, 0.2, 0.3, 0, False),
    "empty_rows_cols": (30, 24, 28, 0.3, 0.3, 0, True),
    "padded": (25, 25, 25, 0.2, 0.2, 500, False),
    "empty_A": (12, 20, 15, 0.0, 0.3, 0, False),
    "empty_B": (12, 20, 15, 0.3, 0.0, 64, False),
}


def _flop_tuples(rng, m, n, density, empty_lines):
    I, J, X = _tuples(rng, m, n, density, "FP32")
    if empty_lines:
        keep = (I % 3 != 0) & (J % 3 != 0)
        I, J, X = I[keep], J[keep], X[keep]
    return I, J, X


def _flop_operands(case, device="cpu"):
    """(JAX A, JAX B, port A, port B) of one case, all with host
    patterns; the port's on ``device``."""
    m, k, n, da, db, extra, empty_lines = FLOP_CASES[case]
    rng = np.random.default_rng(sorted(FLOP_CASES).index(case))
    out = []
    for (r, c, d) in ((m, k, da), (k, n, db)):
        I, J, X = _flop_tuples(rng, r, c, d, empty_lines)
        nzmax = len(I) + extra if extra else None
        Xj = jsp.CsrMatrix.from_coo(I, J, X, r, c, type=gb.FP32,
                                    nzmax=nzmax, sum_duplicates=False)
        Xt = gt.csr_from_coo(I, J, X, r, c, type=gt.FP32, nzmax=nzmax,
                             sum_duplicates=False, device=device)
        out.append((Xj, Xt))
    (Aj, At), (Bj, Bt) = out
    return Aj, Bj, At, Bt


def _numpy_lanes(A, B) -> np.ndarray:
    """The host formula the device count replaced, per live A entry: B's
    row degree at the entry's column id."""
    hpA, hpB = A._options["host_pattern"], B._options["host_pattern"]
    k = A.ncols
    return np.bincount(hpB[0][:B.nvals], minlength=k + 1)[hpA[1][:A.nvals]]


def _numpy_flops(A, B) -> int:
    return int(_numpy_lanes(A, B).sum())


@pytest.mark.parametrize("case", sorted(FLOP_CASES))
def test_device_flopcount_matches_numpy(case):
    """``csr_flopcount`` on the CSR arrays equals the numpy formula over
    the host patterns, padding sentinels and empty operands included, on
    the CPU and on a card where one is present."""
    from graphblas_tpu_torch.ops.flopcount import csr_flopcount
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        _, _, A, B = _flop_operands(case, dev)
        if FLOP_CASES[case][5]:
            assert A.nvals < A.nzmax and B.nvals < B.nzmax
        counters.reset()
        got = csr_flopcount(A, B)
        assert isinstance(got, int)
        assert got == _numpy_flops(A, B)
        assert counters.stats()["counts"] == {"flopcount.exact": 1,
                                              "reads": 1}


@pytest.mark.parametrize("case", sorted(FLOP_CASES))
def test_entry_lanes_and_flop_blocks(case):
    """``entry_lanes`` equals the numpy formula per entry (0 on padded
    slots), and ``flop_blocks`` over its cumulative sum gives contiguous
    blocks from entry 0 that hold every lane, each within the cap unless
    it is a single entry, on the CPU and on a card where one is
    present."""
    from graphblas_tpu_torch.ops.flopcount import entry_lanes, flop_blocks
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        _, _, A, B = _flop_operands(case, dev)
        lanes = entry_lanes(A, B)
        assert lanes.dtype == torch.int64 and lanes.shape == (A.nzmax,)
        assert lanes.device == A.indices.device
        lanes = lanes.cpu().numpy()
        assert np.array_equal(lanes[:A.nvals], _numpy_lanes(A, B))
        assert not lanes[A.nvals:].any()
        csum = np.cumsum(lanes)
        total = _numpy_flops(A, B)
        for cap in sorted({1, 5, max(1, total // 4), max(1, total)}):
            blocks = flop_blocks(csum, cap)
            if total == 0:
                assert blocks == []
                continue
            assert blocks[0][0] == 0 and blocks[-1][1] <= A.nzmax
            assert all(e0 == s1 for (_, e0), (s1, _) in zip(blocks,
                                                            blocks[1:]))
            per = [int(lanes[s:e].sum()) for s, e in blocks]
            assert sum(per) == total
            assert all(e > s and (p <= cap or e - s == 1)
                       for (s, e), p in zip(blocks, per))


@pytest.mark.parametrize("case", sorted(FLOP_CASES))
def test_mxm_exact_flops_match_numpy_and_jax(case):
    """Through ``mxm``: with host patterns the modelled flops are the
    numpy formula's (at least 1), as the JAX package's, and the engine
    is the JAX package's; one exact count and one read of it."""
    Aj, Bj, At, Bt = _flop_operands(case)
    m, n = At.nrows, Bt.ncols
    C0j, C0t = empty_both(m, n, "FP32")
    counters.reset()
    jcounters.reset()
    counters.trace_spans(True)
    try:
        gt.mxm(C0t, None, None, gt.semiring.plus_times[gt.FP32], At, Bt)
    finally:
        counters.trace_spans(False)
    jmxm(C0j, None, None, jsemiring.plus_times[gb.FP32], Aj, Bj)
    st = counters.stats()
    assert st["modelled_flops"] == max(1, _numpy_flops(At, Bt))
    assert st["modelled_flops"] == jcounters.stats()["modelled_flops"]
    assert gt.last_axb_method() == jfc.last_axb_method()
    assert st["counts"]["flopcount.exact"] == 1
    assert st["spans"]["gb.read.flopcount"]["count"] == 1


def test_mxm_without_host_pattern_takes_the_estimate():
    """Operands with no host pattern keep the estimate nnz(A)·nnz(B)/k:
    no exact count, no read of it, and the JAX package's engine."""
    Aj, Bj, At, Bt = _flop_operands("rectangular")
    for X in (Aj, Bj, At, Bt):
        del X._options["host_pattern"]
    k = At.ncols
    C0j, C0t = empty_both(At.nrows, Bt.ncols, "FP32")
    counters.reset()
    jcounters.reset()
    counters.trace_spans(True)
    try:
        gt.mxm(C0t, None, None, gt.semiring.plus_times[gt.FP32], At, Bt)
    finally:
        counters.trace_spans(False)
    jmxm(C0j, None, None, jsemiring.plus_times[gb.FP32], Aj, Bj)
    st = counters.stats()
    assert st["modelled_flops"] == max(1, At.nvals * Bt.nvals // k)
    assert st["modelled_flops"] == jcounters.stats()["modelled_flops"]
    assert gt.last_axb_method() == jfc.last_axb_method()
    assert "flopcount.exact" not in st["counts"]
    assert "gb.read.flopcount" not in st["spans"]
    assert "gb.planning.flopcount" in st["spans"]
