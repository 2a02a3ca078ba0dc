"""PyTorch port, the hypersparse container (``sparse/hyper.py``): parity
with the JAX package.

Mirrors ``tests/test_hyper.py``: small random graphs embedded at
scattered 60-bit coordinates go through the JAX package's
``graphblas_tpu.sparse.hyper`` and the port's ``graphblas_tpu_torch``
counterpart from the same numpy-seeded tuples.  Patterns, ids, integers
and booleans must be equal exactly, FP64 values within rtol 1e-12 and
FP32 within 1e-6 (reassociation of the segment folds); each result is
also held against a dict oracle over the tuples.  The port's ``h`` and
``hptr`` must equal the JAX package's over the present rows.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu.sparse.hyper as jh
import graphblas_tpu_torch as gt
import graphblas_tpu_torch.sparse.hyper as th
from graphblas_tpu_torch.convert import from_jax

N60 = 1 << 60
CPU = "cpu"


def huge_ids(rng, n):
    """n distinct sorted 60-bit coordinates spread over the full range."""
    ids = np.unique(rng.integers(0, N60, 4 * n, dtype=np.int64))[:n]
    assert len(ids) == n
    return ids


def rand_tuples(rng, ids_r, ids_c, density, tname="FP64"):
    p = rng.random((len(ids_r), len(ids_c))) < density
    li, lj = np.nonzero(p)
    dt = np.dtype(getattr(gb, tname).dtype)
    if tname == "BOOL":
        X = np.ones(len(li), bool)
    elif dt.kind == "f":
        X = rng.standard_normal(len(li)).astype(dt)
    else:
        X = rng.integers(1, 9, len(li)).astype(dt)
    return ids_r[li], ids_c[lj], X


def both(I, J, X, m=N60, n=N60, tname="FP64", dup="PLUS"):
    """(port, JAX) HyperMatrix of the same tuples."""
    return (gt.hyper_from_coo(I, J, X, m, n, type=getattr(gt, tname),
                              dup=dup, device=CPU),
            jh.hyper_from_coo(I, J, X, m, n, type=getattr(gb, tname),
                              dup=dup))


def as_dict(H):
    I, J, X = H.extractTuples()
    return {(int(i), int(j)): x for i, j, x in
            zip(np.asarray(I), np.asarray(J), np.asarray(X).tolist())}


def _tol(dtype):
    return 1e-6 if np.dtype(dtype) == np.float32 else 1e-12


def same(Ht, Hj):
    """Equal patterns, ids, present-row lists and values (floats within
    reassociation tolerance)."""
    assert Ht.shape == tuple(Hj.shape)
    assert Ht.nvals == Hj.nvals and Ht.nvec == Hj.nvec
    ti, tj, tx = Ht.extractTuples()
    ji, jj, jx = (np.asarray(a) for a in Hj.extractTuples())
    assert np.array_equal(ti, ji) and np.array_equal(tj, jj)
    assert tx.dtype == jx.dtype
    if tx.dtype.kind == "f":
        np.testing.assert_allclose(tx, jx, rtol=_tol(tx.dtype), atol=0)
    else:
        assert np.array_equal(tx, jx)
    nv = Ht.nvec
    assert np.array_equal(Ht.h[:nv].numpy(), np.asarray(Hj.h)[:nv])
    assert np.array_equal(Ht.hptr[:nv + 1].numpy(),
                          np.asarray(Hj.hptr)[:nv + 1])


def approx_oracle(got, exp, dtype):
    assert set(got) == set(exp)
    if np.dtype(dtype).kind == "f":
        rtol = 1e-4 if np.dtype(dtype) == np.float32 else 1e-8
        for k in exp:
            assert np.isclose(got[k], exp[k], rtol=rtol, atol=1e-10)
    else:
        for k in exp:
            assert got[k] == exp[k]


SR_FAMILIES = [
    ("plus", "times", "FP64"),
    ("plus", "times", "INT32"),
    ("min", "plus", "FP64"),
    ("max", "second", "INT64"),
    ("lor", "land", "BOOL"),
    ("plus", "minus", "FP64"),   # non-commutative mult: operand order
    ("min", "first", "INT32"),
    ("times", "times", "FP32"),
]

_ADD = {"plus": lambda a, b: a + b, "min": min, "max": max,
        "lor": lambda a, b: bool(a) or bool(b), "times": lambda a, b: a * b}
_MULT = {"times": lambda a, b: a * b, "plus": lambda a, b: a + b,
         "second": lambda a, b: b, "first": lambda a, b: a,
         "land": lambda a, b: bool(a) and bool(b),
         "minus": lambda a, b: a - b}


def oracle_mxm(addname, multname, dtype, dA, dB):
    add, mult = _ADD[addname], _MULT[multname]
    dC = {}
    cols_of = {}
    for (k, j), b in dB.items():
        cols_of.setdefault(k, []).append((j, b))
    for (i, k), a in dA.items():
        for j, b in cols_of.get(k, ()):
            z = mult(a, b)
            dC[(i, j)] = add(dC[(i, j)], z) if (i, j) in dC else z
    if np.dtype(dtype).kind in "iub":
        dC = {k: np.asarray(v).astype(dtype).item() for k, v in dC.items()}
    return dC


def semirings(addname, multname, tname):
    name = f"{addname}_{multname}"
    return (gt.semiring[name][getattr(gt, tname)],
            gb.semiring[name][getattr(gb, tname)])


@pytest.mark.parametrize("addname,multname,tname", SR_FAMILIES,
                         ids=[f"{a}_{m}_{t}" for a, m, t in SR_FAMILIES])
def test_hyper_spgemm_matches_oracle(addname, multname, tname):
    rng = np.random.default_rng(101)
    ids = huge_ids(rng, 24)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3, tname), tname=tname)
    Bt, Bj = both(*rand_tuples(rng, ids, ids, 0.3, tname), tname=tname)
    srt, srj = semirings(addname, multname, tname)
    Ct = th.hyper_spgemm(srt, At, Bt)
    Cj = jh.hyper_spgemm(srj, Aj, Bj)
    assert Ct.shape == (N60, N60)
    same(Ct, Cj)
    approx_oracle(as_dict(Ct), oracle_mxm(addname, multname,
                                          srt.ztype.dtype, as_dict(Aj),
                                          as_dict(Bj)), srt.ztype.dtype)
    assert gt.last_axb_method() == "esc:hyper_spgemm"


@pytest.mark.parametrize("complement", [False, True])
def test_hyper_spgemm_masked(complement):
    rng = np.random.default_rng(102)
    ids = huge_ids(rng, 20)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3))
    Bt, Bj = both(*rand_tuples(rng, ids, ids, 0.3))
    Mt, Mj = both(*rand_tuples(rng, ids, ids, 0.4))
    srt, srj = semirings("plus", "times", "FP64")
    Ct = th.hyper_spgemm(srt, At, Bt, mask=Mt, complement=complement)
    same(Ct, jh.hyper_spgemm(srj, Aj, Bj, mask=Mj, complement=complement))
    full = oracle_mxm("plus", "times", np.float64, as_dict(Aj), as_dict(Bj))
    dM = as_dict(Mj)
    approx_oracle(as_dict(Ct), {k: v for k, v in full.items()
                                if (k in dM) != complement}, np.float64)


def test_hyper_spgemm_valued_vs_structural_mask():
    """A zero-valued mask entry hides output under the valued mask but
    shows it under the structural one."""
    rng = np.random.default_rng(103)
    ids = huge_ids(rng, 12)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.4))
    full = oracle_mxm("plus", "times", np.float64, as_dict(Aj), as_dict(Aj))
    mk = sorted(full)[: max(1, len(full) // 2)]
    mi = np.array([k[0] for k in mk], np.int64)
    mj = np.array([k[1] for k in mk], np.int64)
    mx = np.ones(len(mk))
    mx[::2] = 0.0  # explicit zeros
    Mt, Mj = both(mi, mj, mx)
    srt, srj = semirings("plus", "times", "FP64")
    for structural in (False, True):
        Ct = th.hyper_spgemm(srt, At, At, mask=Mt, structural=structural)
        same(Ct, jh.hyper_spgemm(srj, Aj, Aj, mask=Mj,
                                 structural=structural))
        want = {k: full[k] for k, x in zip(mk, mx) if structural or x != 0}
        approx_oracle(as_dict(Ct), want, np.float64)


def test_hyper_matches_csr_engine():
    """Rank-compressed coordinates: the hyper ESC product agrees with the
    port's CSR ESC product entry for entry."""
    rng = np.random.default_rng(104)
    ids = huge_ids(rng, 40)
    tA = rand_tuples(rng, ids, ids, 0.2)
    tB = rand_tuples(rng, ids, ids, 0.2)
    At, _ = both(*tA)
    Bt, _ = both(*tB)
    n = len(ids)

    def compress(t):
        I, J, X = t
        return gt.CsrMatrix.from_coo(np.searchsorted(ids, I),
                                     np.searchsorted(ids, J), X, n, n,
                                     type=gt.FP64, device=CPU)
    srt, _ = semirings("plus", "times", "FP64")
    Ch = th.hyper_spgemm(srt, At, Bt)
    Cc = gt.csr_spgemm(srt, compress(tA), compress(tB))
    I, J, X = Cc.extractTuples()
    hi, hj, hx = Ch.extractTuples()
    assert np.array_equal(hi, ids[I]) and np.array_equal(hj, ids[J])
    np.testing.assert_allclose(hx, X, rtol=1e-12)


EWISE_OPS = [("plus", True), ("times", False), ("min", True),
             ("minus", False), ("max", True)]


@pytest.mark.parametrize("opname,union", EWISE_OPS)
def test_hyper_ewise(opname, union):
    rng = np.random.default_rng(105)
    ids = huge_ids(rng, 30)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3))
    Bt, Bj = both(*rand_tuples(rng, ids, ids, 0.3))
    Ct = th.hyper_ewise(gt.binary[opname][gt.FP64], At, Bt, union=union)
    same(Ct, jh.hyper_ewise(gb.binary[opname][gb.FP64], Aj, Bj,
                            union=union))
    fold = _MULT.get(opname) or _ADD[opname]
    dA, dB = as_dict(Aj), as_dict(Bj)
    if union:
        want = dict(dA)
        for k, v in dB.items():
            want[k] = fold(want[k], v) if k in want else v
    else:
        want = {k: fold(dA[k], dB[k]) for k in dA if k in dB}
    approx_oracle(as_dict(Ct), want, np.float64)


def test_hyper_mxv_sparse_vector():
    rng = np.random.default_rng(106)
    ids = huge_ids(rng, 25)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3))
    sel = np.sort(rng.choice(ids, 10, replace=False))
    xv = rng.standard_normal(10)
    srt, srj = semirings("plus", "times", "FP64")
    ti, tv = th.hyper_mxv(srt, At, sel, xv)
    ji, jv = jh.hyper_mxv(srj, Aj, sel, xv)
    assert np.array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-12)
    xd = dict(zip(sel.tolist(), xv.tolist()))
    dy = {}
    for (i, j), a in as_dict(Aj).items():
        if j in xd:
            dy[i] = dy.get(i, 0.0) + a * xd[j]
    assert set(ti.tolist()) == set(dy)


def test_hyper_reduce_apply_select_transpose():
    rng = np.random.default_rng(107)
    ids = huge_ids(rng, 20)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.35))
    dA = as_dict(Aj)
    st = th.hyper_reduce_scalar(gt.monoid.plus[gt.FP64], At)
    sj = jh.hyper_reduce_scalar(gb.monoid.plus[gb.FP64], Aj)
    assert isinstance(st, np.float64)
    assert np.isclose(st, sj, rtol=1e-12) and np.isclose(
        st, sum(dA.values()))
    ti, tv = th.hyper_reduce_vector(gt.monoid.plus[gt.FP64], At)
    ji, jv = jh.hyper_reduce_vector(gb.monoid.plus[gb.FP64], Aj)
    assert np.array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-12)
    same(th.hyper_apply(gt.unary.ainv[gt.FP64], At),
         jh.hyper_apply(gb.unary.ainv[gb.FP64], Aj))
    for nm in ("TRIL", "TRIU", "DIAG", "OFFDIAG", "NONZERO"):
        same(th.hyper_select(nm, At), jh.hyper_select(nm, Aj))
    same(th.hyper_transpose(At), jh.hyper_transpose(Aj))
    assert as_dict(th.hyper_transpose(At)) == {(j, i): v
                                               for (i, j), v in dA.items()}


def test_hyper_build_dup_fold_and_bounds():
    I = np.array([7, 7, 3, 3, 3], np.int64) * (1 << 50)
    J = np.array([1, 1, 2, 2, 2], np.int64) * (1 << 40)
    X = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    for dup in ("PLUS", "MIN", "MAX", "FIRST", "SECOND", "TIMES"):
        same(*both(I, J, X, dup=dup))
    At, _ = both(I, J, X)
    assert as_dict(At) == {(7 << 50, 1 << 40): 3.0, (3 << 50, 2 << 40): 28.0}
    # unsigned MIN/MAX fold in the unsigned order, values past 2^63 and
    # 2^31 (the JAX package's reduceat on real unsigned dtypes)
    for tname, big in (("UINT64", (1 << 63) + 5), ("UINT32", (1 << 31) + 5)):
        dt = np.dtype(getattr(gb, tname).dtype)
        Xu = np.array([big, 3, 7, big + 1, 2], dt)
        for dup in ("MIN", "MAX", "PLUS"):
            Ht, Hj = both(I, J, Xu, tname=tname, dup=dup)
            same(Ht, Hj)
        Ht, Hj = both(I, J, Xu, tname=tname, dup="MAX")
        assert Ht.extractElement(3 << 50, 2 << 40) == big + 1
        # the same values given in signed storage fold the same way
        Hs = gt.hyper_from_coo(I, J, Xu.view(dt.str.replace("u", "i")),
                               N60, N60, type=getattr(gt, tname), dup="MAX",
                               device=CPU)
        same(Hs, Hj)
    with pytest.raises(gt.IndexOutOfBounds):
        gt.hyper_from_coo([-1], [0], [1.0], N60, N60, device=CPU)
    with pytest.raises(gt.IndexOutOfBounds):
        gt.hyper_from_coo([0], [N60], [1.0], N60, N60, device=CPU)
    with pytest.raises(ValueError):
        gt.hyper_from_coo([0], [0], [1.0], 2 * N60, N60, device=CPU)


def test_hyper_mxm_dispatch_and_descriptor():
    """gt.mxm routes a HyperMatrix output to the hypersparse engine and
    honours the transpose descriptors, as gb.mxm."""
    rng = np.random.default_rng(108)
    ids = huge_ids(rng, 15)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3))
    Bt, Bj = both(*rand_tuples(rng, ids, ids, 0.3))
    srt, srj = semirings("plus", "times", "FP64")
    same(gt.mxm(At, None, None, srt, At, Bt),
         gb.mxm(Aj, None, None, srj, Aj, Bj))
    same(gt.mxm(At, None, None, srt, At, Bt, gt.Descriptor(tran0=True)),
         gb.mxm(Aj, None, None, srj, Aj, Bj, gb.Descriptor(tran0=True)))
    same(gt.mxm(At, None, None, "plus_times", At, Bt, gt.TRAN1),
         gb.mxm(Aj, None, None, srj, Aj, Bj, gb.Descriptor(tran1=True)))


def test_hyper_mxm_accum_mask_epilogue():
    """C<M> = accum(C, A*B) with and without REPLACE: the epilogue on
    hypersparse operands."""
    rng = np.random.default_rng(109)
    ids = huge_ids(rng, 15)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3))
    Bt, Bj = both(*rand_tuples(rng, ids, ids, 0.3))
    Ct, Cj = both(*rand_tuples(rng, ids, ids, 0.3))
    Mt, Mj = both(*rand_tuples(rng, ids, ids, 0.5))
    srt, srj = semirings("plus", "times", "FP64")
    for replace in (False, True):
        for scmp in (False, True):
            dt = gt.Descriptor(replace=replace, mask_scmp=scmp)
            dj = gb.Descriptor(replace=replace, mask_scmp=scmp)
            same(gt.mxm(Ct, Mt, gt.binary.plus[gt.FP64], srt, At, Bt, dt),
                 gb.mxm(Cj, Mj, gb.binary.plus[gb.FP64], srj, Aj, Bj, dj))


def test_hyper_import_export_roundtrip():
    rng = np.random.default_rng(110)
    ids = huge_ids(rng, 18)
    At, Aj = both(*rand_tuples(rng, ids, ids, 0.3))
    out = gt.export_hyper_csr(At)
    outj = gb.export_hyper_csr(Aj)
    for x, y in zip(out, outj):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    nrows, ncols, nvec, h, p, indices, values = out
    assert nrows == N60 and nvec == At.nvec and np.all(np.diff(h) > 0)
    B = gt.import_hyper_csr(*out, type=gt.FP64, device=CPU)
    assert isinstance(B, gt.HyperMatrix)   # too big to collapse to CSR
    same(B, Aj)
    # small dimension: CSR, then the hyper_ratio rule (2 of 100 rows ->
    # stays hypersparse); NEVER_HYPER collapses it to CSR
    St, Sj = both([0, 5], [1, 3], [1.0, 2.0], 100, 100)
    C = gt.import_hyper_csr(*gt.export_hyper_csr(St), type=gt.FP64,
                            device=CPU)
    Cj = gb.import_hyper_csr(*gb.export_hyper_csr(Sj), type=gb.FP64)
    assert isinstance(C, gt.HyperMatrix) and type(Cj).__name__ == \
        "HyperMatrix"
    same(C, Cj)
    C = gt.hyper_conform(C, gt.GxB_NEVER_HYPER)
    assert isinstance(C, gt.CsrMatrix)
    assert as_dict(C) == {(0, 1): 1.0, (5, 3): 2.0}
    # the CSR forms and the vector round-trip
    for x, y in zip(gt.export_csr(C), gb.export_csr(
            jh.hyper_conform(Cj, jh.GxB_NEVER_HYPER))):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    R = gt.import_csr(*gt.export_csr(C), type=gt.FP64, device=CPU)
    assert as_dict(R) == as_dict(C)
    Rc = gt.import_csc(*gt.export_csc(C), type=gt.FP64, device=CPU)
    assert as_dict(Rc) == as_dict(C)
    v = gt.import_vector(6, [1, 4], [2.0, 3.0], device=CPU)
    assert [a.tolist() for a in gt.export_vector(v)[1:]] == \
        [[1, 4], [2.0, 3.0]]


def test_hyper_csr_interop():
    St, Sj = both([0, 1, 2, 2], [1, 2, 0, 5], [1.0, 2.0, 3.0, 4.0], 100,
                  100)
    csr = St.to_csr()
    assert isinstance(csr, gt.CsrMatrix)
    same(gt.HyperMatrix.from_csr(csr), Sj)
    assert np.array_equal(St.rows_present(), np.asarray(Sj.rows_present()))
    assert np.array_equal(St.row_degrees(), np.asarray(Sj.row_degrees()))
    from graphblas_tpu.ops.containers import is_sparse_container as jsc
    from graphblas_tpu_torch.ops.containers import is_sparse_container
    assert is_sparse_container(St) and is_sparse_container(csr)
    assert not is_sparse_container(gt.SparseVec.from_coo(
        [1], [1.0], 4, device=CPU)) and not jsc(jh.HyperMatrix)
    # the host cast of the accum/mask epilogue's values
    for src, dst in (("FP64", "INT8"), ("INT64", "UINT32"),
                     ("UINT64", "FP32"), ("FP32", "BOOL")):
        x = np.array([-3.7, 0.0, 2.5e9, 7.0]).astype(
            getattr(gb, src).dtype)
        got = th.cast_host(x, getattr(gt, dst))
        want = np.asarray(jh.cast_host(x, getattr(gb, dst)))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        gt.hyper_from_coo([0], [0], [1.0], N60, N60, device=CPU).to_csr()


def test_hyper_empty_and_degenerate():
    rng = np.random.default_rng(111)
    Et, Ej = both(np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.zeros(0))
    assert Et.nvals == 0 and Et.nvec == 0
    srt, srj = semirings("plus", "times", "FP64")
    assert th.hyper_spgemm(srt, Et, Et).nvals == 0
    ids = huge_ids(rng, 5)
    At, _ = both(*rand_tuples(rng, ids, ids, 0.5))
    # A's column ids are in ids; B's rows are ids + 1: no overlap
    Bt, _ = both(ids + 1, ids + 1, np.ones(len(ids)))
    assert th.hyper_spgemm(srt, At, Bt).nvals == 0
    assert th.hyper_reduce_scalar(gt.monoid.plus[gt.FP64], Et) == 0.0
    assert gt.reduce_to_scalar(None, gt.monoid.max[gt.FP64], Et) == -np.inf


def test_hyper_conform_hysteresis():
    n = 1024
    # 8 non-empty rows out of 1024: 8 <= 1024/16 -> becomes hyper
    I = np.repeat(np.arange(8) * 100, 4)
    J = np.tile(np.arange(4), 8)
    X = np.arange(32, dtype=np.float32)
    A = gt.CsrMatrix.from_coo(I, J, X, n, n, device=CPU)
    assert gt.nvec_nonempty(A) == 8
    H = gt.hyper_conform(A)
    assert isinstance(H, gt.HyperMatrix) and H.nvec == 8
    same(H, jh.hyper_conform(gb.sparse.CsrMatrix.from_coo(I, J, X, n, n)))
    # in the hysteresis band (64 < nvec=128 <= 128): each stays as it is
    I2 = np.arange(128) * 8
    B = gt.CsrMatrix.from_coo(I2, np.zeros(128, np.int64),
                              np.ones(128, np.float32), n, n, device=CPU)
    assert isinstance(gt.hyper_conform(gt.HyperMatrix.from_csr(B)),
                      gt.HyperMatrix)
    assert isinstance(gt.hyper_conform(B), gt.CsrMatrix)
    # past 2*n*ratio (nvec=200 > 128): hyper drops to CSR
    I3 = np.arange(200) * 5
    H3 = gt.HyperMatrix.from_coo(I3, np.zeros(200, np.int64),
                                 np.ones(200, np.float32), n, n, device=CPU)
    C3 = gt.hyper_conform(H3)
    assert isinstance(C3, gt.CsrMatrix)
    np.testing.assert_array_equal(C3.extractTuples()[0], I3)


def test_hyper_conform_sentinels_and_options():
    n = 64
    I = np.arange(40)  # 40 of 64 rows: dense-ish, the default keeps CSR
    A = gt.CsrMatrix.from_coo(I, I, np.ones(40, np.float32), n, n,
                              device=CPU)
    assert isinstance(gt.hyper_conform(A), gt.CsrMatrix)
    assert isinstance(gt.hyper_conform(A, gt.GxB_ALWAYS_HYPER),
                      gt.HyperMatrix)
    H = gt.HyperMatrix.from_csr(A)
    assert isinstance(gt.hyper_conform(H, gt.GxB_NEVER_HYPER), gt.CsrMatrix)
    assert isinstance(gt.hyper_conform(H, gt.GxB_ALWAYS_HYPER),
                      gt.HyperMatrix)
    # the matrix's own option wins over the global default, and travels
    # with the conversion; the global option is read otherwise
    A._options["hyper_ratio"] = gt.GxB_ALWAYS_HYPER
    out = gt.hyper_conform(A)
    assert isinstance(out, gt.HyperMatrix)
    assert out._options["hyper_ratio"] == gt.GxB_ALWAYS_HYPER
    assert "host_pattern" not in out._options
    B = gt.CsrMatrix.from_coo(I, I, np.ones(40, np.float32), n, n,
                              device=CPU)
    gt.set_option("hyper_ratio", 1.0)
    try:
        assert isinstance(gt.hyper_conform(B), gt.HyperMatrix)
    finally:
        gt.set_option("hyper_ratio", gt.GxB_HYPER_DEFAULT)


def test_hyper_conform_dimension_override():
    big = 1 << 40
    H = gt.HyperMatrix.from_coo(np.array([0, big - 1]), np.array([1, 2]),
                                np.ones(2, np.float32), big, big,
                                device=CPU)
    # NEVER_HYPER cannot force an impossible O(nrows) indptr
    assert isinstance(gt.hyper_conform(H, gt.GxB_NEVER_HYPER),
                      gt.HyperMatrix)


def test_import_hyper_csr_conforms():
    n = 1 << 20
    h = np.array([3, 77777], np.int64)
    p = np.array([0, 2, 3], np.int64)
    args = (n, n, 2, h, p, np.array([1, 5, 9]),
            np.array([1.0, 2.0, 3.0], np.float32))
    out = gt.import_hyper_csr(*args, type=gt.FP32, device=CPU)
    # 2 non-empty rows of 2^20 -> conforms to hypersparse
    assert isinstance(out, gt.HyperMatrix) and out.nvec == 2
    same(out, gb.import_hyper_csr(*args, type=gb.FP32))


def test_hyper_spgemm_lane_cap_delegates():
    """Beyond the lane cap a CSR-sized product runs on the chunked CSR
    engine (same result); a huge-dimension one raises clearly."""
    import graphblas_tpu_torch.sparse.esc as esc_mod
    r = np.random.default_rng(7)
    n = 300
    I = r.integers(0, n, 3000)
    J = r.integers(0, n, 3000)
    lin = np.unique(I * n + J)
    I, J = lin // n, lin % n
    X = (r.random(len(I)) + 0.5).astype(np.float32)
    At, Aj = both(I, J, X, n, n, "FP32", dup=None)
    Bt, Bj = both(J, I, X, n, n, "FP32", dup=None)
    srt, srj = semirings("plus", "times", "FP32")
    ref = th.hyper_spgemm(srt, At, Bt)
    same(ref, jh.hyper_spgemm(srj, Aj, Bj))
    old = esc_mod._ESC_LANE_CAP
    esc_mod._ESC_LANE_CAP = 1 << 12
    try:
        got = th.hyper_spgemm(srt, At, Bt)
        assert gt.last_axb_method() == "esc:chunked"
    finally:
        esc_mod._ESC_LANE_CAP = old
    same(got, jh.hyper_spgemm(srj, Aj, Bj))
    H = gt.hyper_from_coo(np.array([0, 1 << 39]), np.array([1 << 39, 7]),
                          np.ones(2, np.float32), 1 << 40, 1 << 40,
                          type=gt.FP32, dup=None, device=CPU)
    esc_mod._ESC_LANE_CAP = 0
    try:
        with pytest.raises(NotImplementedError, match="lane cap"):
            th.hyper_spgemm(srt, H, H)
    finally:
        esc_mod._ESC_LANE_CAP = old


def test_hyper_lor_land_reduce_follows_the_op():
    """LOR/LAND over non-bool hypersparse values fold by the op (0/1);
    the JAX package's hypersparse reduce takes a max/min of the values,
    recorded here as the reference's."""
    I = np.array([1, 1, 2], np.int64) << 50
    J = np.array([3, 5, 3], np.int64) << 40
    X = np.array([-1, -2, 0], np.int8)
    At, Aj = both(I, J, X, tname="INT8")
    ti, tv = th.hyper_reduce_vector(gt.monoid.lor[gt.INT8], At)
    ji, jv = jh.hyper_reduce_vector(gb.monoid.lor[gb.INT8], Aj)
    assert np.array_equal(ti, np.asarray(ji))
    assert tv.tolist() == [1, 0] and np.asarray(jv).tolist() == [-1, 0]
    assert th.hyper_reduce_scalar(gt.monoid.land[gt.INT8], At) == 0
    assert jh.hyper_reduce_scalar(gb.monoid.land[gb.INT8], Aj) == -2


def test_from_jax_hyper_containers():
    """``from_jax`` carries a HyperMatrix, HyperCscMatrix and SparseVec
    across with their pending tuples and options."""
    rng = np.random.default_rng(112)
    ids = huge_ids(rng, 10)
    _, Aj = both(*rand_tuples(rng, ids, ids, 0.4))
    Aj._options["hyper_ratio"] = 0.5
    Pj = Aj.setElement(7.5, int(ids[0]), int(ids[3])).setElement(
        1.0, int(ids[1]), int(ids[1]), accum=gb.binary.plus[gb.FP64])
    At = from_jax(Pj, device=CPU)
    assert len(At._pending) == 2 and At._options["hyper_ratio"] == 0.5
    same(At.wait(), Pj.wait())
    Cj = gb.sparse.HyperCscMatrix(Aj)
    Ct = from_jax(Cj, device=CPU)
    assert isinstance(Ct, gt.HyperCscMatrix)
    same(Ct.tr, Cj.tr)
    vj = gb.sparse.SparseVec.from_coo(ids[:3], [1.0, 2.0, 3.0], N60)
    vt = from_jax(vj, device=CPU)
    assert isinstance(vt, gt.SparseVec)
    same(vt.hm, vj.hm)
