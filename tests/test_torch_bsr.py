"""PyTorch port, the BSR tile engine (sparse/bsr.py, sparse/cuda_bsr.py,
kernel K7): parity with the JAX package.

Patterns and values are made with numpy from a seed and go through both
packages on the CPU; the JAX package's Pallas kernel runs in interpret
mode there, the port's wrapper runs K7's plain PyTorch version.  Tiles,
schedules, patterns and counts must be exactly equal; float32 values
within rtol=1e-5, atol=1e-4 (the JAX test's tolerance: the product's
terms are summed in another order)."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core.semirings import semiring as jsemiring
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import bsr as jbsr
from graphblas_tpu.sparse import pallas_bsr as jpb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.sparse import bsr as tbsr
from graphblas_tpu_torch.sparse import cuda_bsr as tcb

CPU = "cpu"


def _sym(n, density, seed):
    rng = np.random.default_rng(seed)
    pat = rng.random((n, n)) < density
    return (pat | pat.T) & ~np.eye(n, dtype=bool)


def _both(values, pattern, tname):
    """The same bitmap Matrix in both packages."""
    return (gt.Matrix.from_dense(values, getattr(gt, tname), pattern=pattern,
                                 device=CPU),
            gb.Matrix.from_dense(values, getattr(gb, tname),
                                 pattern=pattern))


def _same_tiles(tp, jp):
    assert np.array_equal(tp.grid, jp.grid)
    assert np.array_equal(tp.index, np.asarray(jp.index))
    assert tuple(tp.shape) == tuple(jp.shape) and tp.T == jp.T
    assert np.array_equal(tp.tiles.numpy(), np.asarray(jp.tiles))


def _check_engine(port_name):
    assert gt.jax_engine_name(port_name) == jax_last_method(), \
        (port_name, jax_last_method())


def test_bsr_tricount_matches_dense():
    pat = _sym(300, 0.04, 9)
    L, U = np.tril(pat, -1), np.triu(pat, 1)
    want = int(((pat.astype(np.float64) @ pat) * pat).sum()) // 6
    assert jsp.tricount_bsr(L, U) == jsp.tricount_bsr_pallas(L, U) == want
    assert gt.tricount_bsr(L, U, device=CPU) == want
    assert gt.tricount_bsr_pallas(L, U, device=CPU) == want


@pytest.mark.parametrize("shape,density,seed", [((200, 300), 0.05, 10),
                                                ((300, 260), 0.03, 13),
                                                ((129, 1), 0.5, 3)])
def test_bsr_rectangular_tiles(shape, density, seed):
    pat = np.random.default_rng(seed).random(shape) < density
    tp = gt.tile_pattern(pat, device=CPU)
    _same_tiles(tp, jsp.tile_pattern(pat))
    # reassemble from tiles and compare
    T = tp.T
    got = np.zeros((tp.grid.shape[0] * T, tp.grid.shape[1] * T), bool)
    for (I, J) in zip(*np.nonzero(tp.grid)):
        got[I * T:(I + 1) * T, J * T:(J + 1) * T] = \
            tp.tiles[tp.index[I, J]].numpy() != 0
    assert np.array_equal(got[:shape[0], :shape[1]], pat)


def test_tile_pattern_from_coo_matches_dense():
    pat = np.random.default_rng(13).random((300, 260)) < 0.03
    I, J = np.nonzero(pat)
    t2 = gt.tile_pattern_from_coo(I, J, pat.shape, device=CPU)
    _same_tiles(t2, gt.tile_pattern(pat, device=CPU))
    _same_tiles(t2, jbsr.tile_pattern_from_coo(I, J, pat.shape))


def test_tile_matrix_matches_jax():
    rng = np.random.default_rng(14)
    pat = rng.random((150, 270)) < 0.05
    vals = rng.normal(size=pat.shape).astype(np.float32)
    _same_tiles(gt.tile_matrix(vals, pat, device=CPU),
                jsp.tile_matrix(vals, pat))


def test_tile_pattern_on_a_tensor_keeps_its_device():
    pat = torch.from_numpy(np.random.default_rng(1).random((70, 90)) < 0.1)
    tp = gt.tile_pattern(pat)
    assert tp.tiles.device.type == "cpu" and tp.tiles.dtype == torch.int8


def test_bsr_masked_count_matches_jax():
    pat = _sym(260, 0.05, 15)
    L, U = np.tril(pat, -1), np.triu(pat, 1)
    Lt, Ut = gt.tile_pattern(L, device=CPU), gt.tile_pattern(U, device=CPU)
    C, outs = gt.bsr_masked_count(Lt, Lt, Ut)
    Cj, outsj = jbsr.bsr_masked_count(*(jsp.tile_pattern(x)
                                        for x in (L, L, U)))
    assert np.array_equal(outs, outsj)
    assert C.dtype == torch.int32
    assert np.array_equal(C.numpy(), np.asarray(Cj))


# (M, A, B'): square, rectangular (m != k != n), an empty mask, and a
# mask whose tiles meet no triple
def _schedule_case(name):
    rng = np.random.default_rng(16)
    if name == "square":
        pat = _sym(400, 0.01, 17)
        return np.tril(pat, -1), np.tril(pat, -1), np.triu(pat, 1).T
    if name == "rectangular":
        A = rng.random((300, 520)) < 0.01
        Bt = rng.random((270, 520)) < 0.01
        return rng.random((300, 270)) < 0.05, A, Bt
    if name == "empty_mask":
        A = rng.random((200, 200)) < 0.05
        return np.zeros((200, 200), bool), A, A
    # A's nonempty tiles all in column block 0, B's in block 1: no triple
    A = np.zeros((260, 260), bool)
    A[:, :100] = rng.random((260, 100)) < 0.05
    B = np.zeros((260, 260), bool)
    B[:, 140:] = rng.random((260, 120)) < 0.05
    return rng.random((260, 260)) < 0.1, A, B


@pytest.mark.parametrize("name", ["square", "rectangular", "empty_mask",
                                  "no_triples"])
def test_build_schedule_matches_jax(name):
    Mp, Ap, Bp = _schedule_case(name)
    tps = [gt.tile_pattern(x, device=CPU) for x in (Mp, Ap, Bp)]
    jps = [jsp.tile_pattern(x) for x in (Mp, Ap, Bp)]
    got, want = tcb.build_schedule(*tps), jpb.build_schedule(*jps)
    if want is None:
        assert got is None
        return
    starts, ta, tb, Mtiles, kmax, outs = got
    for g, w in zip((starts, ta, tb, Mtiles), want[:4]):
        assert g.dtype == (torch.int8 if g is Mtiles else torch.int32)
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert kmax == want[4] and np.array_equal(outs, want[5])
    # the triples are the dense cube's, in its (I, J, K) order
    trip = (tps[0].grid[:, :, None] & tps[1].grid[:, None, :]
            & tps[2].grid[None, :, :])
    I, J, K = gt.sparse.bsr.tile_triples(tps[0].grid, tps[1].grid,
                                         tps[2].grid)
    assert np.array_equal(np.stack([I, J, K]), np.stack(np.nonzero(trip)))


def test_schedule_triples_count_the_window_plan():
    # the window plan's triple count is the BSR schedule's (the JAX
    # window test's check), on a banded graph
    from graphblas_tpu_torch.sparse import window as tw
    rng = np.random.default_rng(2)
    n, bw = 700, 90
    sym = rng.random((n, n)) < 0.15
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    L, U = np.tril(Ap), np.triu(Ap)
    mk = [gt.csr_from_coo(*np.nonzero(x), np.ones(int(x.sum()), bool), n, n,
                          type=gt.BOOL, sum_duplicates=False, device=CPU)
          for x in (L, U)]
    plan = tw.build_window_plan(mk[0], mk[1], mk[0])
    sched = tcb.build_schedule(*(gt.tile_pattern(x, device=CPU)
                                 for x in (L, L, U.T)))
    assert plan.ntriples == sched[1].shape[0]


@pytest.mark.parametrize("acc", ["int32", "float32"])
def test_k7_plain_matches_jax_kernel(acc):
    """The kernel's plain version against the Pallas kernel (interpret
    mode) on the same tiles and schedule."""
    rng = np.random.default_rng(18)
    pat = _sym(300, 0.03, 19)
    M, A, B = np.tril(pat, -1), pat, pat
    if acc == "int32":
        tps = [gt.tile_pattern(x, device=CPU) for x in (M, A, B)]
        jps = [jsp.tile_pattern(x) for x in (M, A, B)]
    else:
        va = rng.normal(size=pat.shape).astype(np.float32)
        vb = rng.normal(size=pat.shape).astype(np.float32)
        tps = [gt.tile_pattern(M, device=CPU),
               gt.tile_matrix(va, A, device=CPU),
               gt.tile_matrix(vb, B, device=CPU)]
        jps = [jsp.tile_pattern(M), jsp.tile_matrix(va, A),
               jsp.tile_matrix(vb, B)]
    C, outs = gt.bsr_masked_mm_pallas(*tps, getattr(torch, acc))
    Cj, outsj = jsp.bsr_masked_mm_pallas(*jps, getattr(np, acc))
    assert np.array_equal(outs, outsj)
    assert C.dtype == getattr(torch, acc)
    if acc == "int32":
        assert np.array_equal(C.numpy(), np.asarray(Cj))
    else:
        np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=1e-5,
                                   atol=1e-4)


def test_k7_wrapper_checks_its_arguments():
    tp = gt.tile_pattern(_sym(130, 0.05, 1), device=CPU)
    starts, ta, tb, _, _, _ = tcb.build_schedule(tp, tp, tp)
    mslot = torch.arange(len(starts) - 1, dtype=torch.int32)
    with pytest.raises(TypeError):
        tcb.bsr_tiles_mm(starts, ta, tb, mslot, tp.tiles.float(), tp.tiles,
                         tp.tiles, torch.int32)
    with pytest.raises(TypeError):
        tcb.bsr_tiles_mm(starts, ta, tb, mslot, tp.tiles, tp.tiles,
                         tp.tiles, torch.int64)
    with pytest.raises(TypeError):
        tcb.bsr_tiles_mm(starts.long(), ta, tb, mslot, tp.tiles, tp.tiles,
                         tp.tiles, torch.int32)


def test_bsr_pallas_empty_mask():
    Z = np.zeros((50, 50), bool)
    assert jsp.tricount_bsr_pallas(Z, Z) == 0
    assert gt.tricount_bsr_pallas(Z, Z, device=CPU) == 0
    assert gt.tricount_bsr(Z, Z, device=CPU) == 0
    Zt = gt.tile_pattern(Z, device=CPU)
    C, outs = gt.bsr_masked_mm_pallas(Zt, Zt, Zt)
    assert C.shape == (0, 128, 128) and outs.shape == (0, 2)


def test_bsr_values_masked_mxm():
    rng = np.random.default_rng(11)
    n = 260
    mask = rng.random((n, n)) < 0.05
    Ad = (rng.normal(size=(n, n)) * mask).astype(np.float32)
    Bmask = rng.random((n, n)) < 0.05
    Bd = (rng.normal(size=(n, n)) * Bmask).astype(np.float32)
    Mmask = rng.random((n, n)) < 0.1
    At, Aj = _both(Ad, mask, "FP32")
    Bt, Bj = _both(Bd, Bmask, "FP32")
    Mt, Mj = _both(Mmask.astype(np.float32), Mmask, "FP32")
    Cj = jsp.masked_mxm(Mj, Aj, Bj, semiring=jsemiring.plus_times[gb.FP32])
    C = gt.masked_mxm(Mt, At, Bt, semiring=gt.semiring.plus_times[gt.FP32])
    assert gt.last_axb_method() == "torch:bsr_values"
    _check_engine(gt.last_axb_method())
    assert C.type == gt.FP32
    assert np.array_equal(C.pattern_np(), Cj.pattern_np())
    np.testing.assert_allclose(C.to_dense(), Cj.to_dense(), rtol=1e-5,
                               atol=1e-4)
    want = (Ad.astype(np.float64) @ Bd.astype(np.float64)) * Mmask
    assert np.allclose(C.to_dense(), want.astype(np.float32), atol=1e-4)


def test_bsr_count_masked_mxm():
    pat = _sym(200, 0.08, 12)
    At, Aj = _both(pat, pat, "BOOL")
    C = gt.masked_mxm(At, At, At)  # C<A> = A*A counting
    assert gt.last_axb_method() == "torch:bsr_count"
    Cj = jsp.masked_mxm(Aj, Aj, Aj)
    _check_engine(gt.last_axb_method())
    want = (pat.astype(np.int64) @ pat) * pat
    assert C.type == gt.INT32
    assert np.array_equal(C.to_dense(), want.astype(np.int32))
    assert np.array_equal(C.to_dense(), Cj.to_dense())
    assert np.array_equal(C.pattern_np(), Cj.pattern_np())


def test_masked_mxm_takes_csr_operands():
    pat = _sym(150, 0.08, 21)
    I, J = np.nonzero(pat)
    A = gt.csr_from_coo(I, J, np.ones(len(I), bool), 150, 150, type=gt.BOOL,
                        device=CPU)
    Cb = gt.masked_mxm(A, A, A)
    Aj = jsp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), 150, 150,
                                type=gb.BOOL)
    Cj = jsp.masked_mxm(Aj, Aj, Aj)
    assert np.array_equal(Cb.to_dense(), Cj.to_dense())
    assert np.array_equal(Cb.pattern_np(), Cj.pattern_np())


def test_unmasked_bsr_spgemm():
    rng = np.random.default_rng(70)
    n = 300
    mask = rng.random((n, n)) < 0.04
    Ad = (rng.normal(size=(n, n)) * mask).astype(np.float32)
    Bmask = rng.random((n, n)) < 0.04
    Bd = (rng.normal(size=(n, n)) * Bmask).astype(np.float32)
    At, Aj = _both(Ad, mask, "FP32")
    Bt, Bj = _both(Bd, Bmask, "FP32")
    C = gt.masked_mxm(None, At, Bt, semiring=gt.semiring.plus_times[gt.FP32])
    Cj = jsp.masked_mxm(None, Aj, Bj,
                        semiring=jsemiring.plus_times[gb.FP32])
    want_pat = (mask.astype(np.int64) @ Bmask) > 0
    assert np.array_equal(C.pattern_np(), want_pat)
    assert np.array_equal(C.pattern_np(), Cj.pattern_np())
    np.testing.assert_allclose(C.to_dense(), Cj.to_dense(), rtol=1e-5,
                               atol=1e-4)
    # counting form
    Ab, Abj = _both(mask, mask, "BOOL")
    Cc = gt.masked_mxm(None, Ab, Ab)
    cnt = mask.astype(np.int64) @ mask
    assert np.array_equal(Cc.to_dense(), cnt.astype(np.int32))
    assert np.array_equal(Cc.to_dense(), jsp.masked_mxm(None, Abj,
                                                        Abj).to_dense())


def test_masked_mxm_rejects_unsupported_semiring():
    A = gt.Matrix.from_dense(np.ones((4, 4), np.float32), gt.FP32,
                             device=CPU)
    with pytest.raises(NotImplementedError):
        gt.masked_mxm(None, A, A, semiring=gt.semiring.min_plus[gt.FP32])
    Aj = gb.Matrix.from_dense(np.ones((4, 4), np.float32), gb.FP32)
    with pytest.raises(NotImplementedError):
        jsp.masked_mxm(None, Aj, Aj, semiring=jsemiring.min_plus[gb.FP32])


def test_masked_mxm_rejects_fp64_values():
    A = gt.Matrix.from_dense(np.ones((4, 4)), gt.FP64, device=CPU)
    with pytest.raises(TypeError):
        gt.masked_mxm(None, A, A, semiring=gt.semiring.plus_times[gt.FP64])
    Aj = gb.Matrix.from_dense(np.ones((4, 4)), gb.FP64)
    with pytest.raises(TypeError):
        jsp.masked_mxm(None, Aj, Aj, semiring=jsemiring.plus_times[gb.FP64])


@pytest.mark.parametrize("sr", ["plus_land_INT32", "lor_land_BOOL",
                                "plus_pair_INT32", "max_land_BOOL",
                                "plus_times_BOOL"])
def test_masked_mxm_truthy_counts_and_bool(sr):
    # explicit zeros must not count as truthy pairs for PLUS_LAND; the
    # boolean renames map MAX_LAND and PLUS_TIMES on BOOL to LOR_LAND
    name, tname = sr.rsplit("_", 1)
    Av = np.array([[0.0, 2.0], [3.0, 0.0]])
    Ap = np.ones((2, 2), bool)      # all present, two explicit zeros
    At, Aj = _both(Av, Ap, "FP64")
    C = gt.masked_mxm(None, At, At,
                      semiring=getattr(gt.semiring, name)[getattr(gt, tname)])
    Cj = jsp.masked_mxm(None, Aj, Aj,
                        semiring=getattr(jsemiring, name)[getattr(gb, tname)])
    _check_engine(gt.last_axb_method())
    assert C.type.name == Cj.type.name
    assert np.array_equal(C.to_dense(), Cj.to_dense())
    assert np.array_equal(C.pattern_np(), Cj.pattern_np())
    if name in ("plus_land", "lor_land"):
        want = gb.mxm(gb.Matrix.new(getattr(gb, tname), 2, 2), None, None,
                      getattr(jsemiring, name)[getattr(gb, tname)], Aj, Aj)
        assert np.array_equal(C.to_dense(), want.to_dense())


def test_masked_mxm_pattern_exactness():
    # entries of M where A*B has no structural contribution must be
    # ABSENT in the result, not explicit zeros
    A = np.zeros((130, 130), bool)
    A[0, 1] = A[1, 0] = True      # only one pair
    M = np.ones((130, 130), bool)
    At, Aj = _both(A, A, "BOOL")
    Mt, Mj = _both(M, M, "BOOL")
    pat = gt.masked_mxm(Mt, At, At).pattern_np()
    want = np.zeros_like(M)
    want[0, 0] = want[1, 1] = True
    assert np.array_equal(pat, want)
    assert np.array_equal(pat, jsp.masked_mxm(Mj, Aj, Aj).pattern_np())


def test_masked_mxm_nonfinite_values_form_present_pairs_only():
    """A present inf against an absent entry: the value tiles hold 0
    there, so the JAX masked_mxm forms inf * 0 = NaN (a reference defect,
    ROADMAP queue 3).  The port gives GraphBLAS's answer, the one gt.mxm
    and gb.mxm give on their generic (present-pairs) engines: C[0, 0]
    takes only the pair k = 1, 2 * 4 = 8."""
    sr_t, sr_j = gt.semiring.plus_times[gt.FP32], jsemiring.plus_times[gb.FP32]
    Ap = np.array([[True, True], [False, True]])
    Av = np.array([[np.inf, 2.0], [0, 3.0]], np.float32)
    Bp = np.array([[False, True], [True, True]])
    Bv = np.array([[0, 5.0], [4.0, 1.0]], np.float32)
    ones = np.ones((2, 2), bool)
    (At, Aj), (Bt, Bj) = _both(Av, Ap, "FP32"), _both(Bv, Bp, "FP32")
    Mt, Mj = _both(ones.astype(np.float32), ones, "FP32")
    C = gt.masked_mxm(Mt, At, Bt, semiring=sr_t)
    generic = gt.Descriptor(axb_method="gustavson")
    want_t = gt.mxm(gt.Matrix.new(gt.FP32, 2, 2, device=CPU), Mt, None, sr_t,
                    At, Bt, generic)
    want_j = gb.mxm(gb.Matrix.new(gb.FP32, 2, 2), Mj, None, sr_j, Aj, Bj,
                    gb.Descriptor(axb_method="gustavson"))
    assert np.array_equal(C.pattern_np(), want_j.pattern_np())
    assert np.array_equal(C.to_dense(), want_j.to_dense())
    assert np.array_equal(C.to_dense(), want_t.to_dense())
    assert C.to_dense()[0, 0] == 8.0 and np.isinf(C.to_dense()[0, 1])
    # the reference defect, asserted so a repair there shows up here
    Cj = jsp.masked_mxm(Mj, Aj, Bj, semiring=sr_j)
    assert np.isnan(Cj.to_dense()[0, 0])
    # unmasked, the same
    Cu = gt.masked_mxm(None, At, Bt, semiring=sr_t)
    assert np.array_equal(Cu.to_dense(), want_j.to_dense())


def test_convert_tile_pattern_from_jax():
    pat = np.random.default_rng(5).random((140, 300)) < 0.04
    jp = jsp.tile_pattern(pat)
    _same_tiles(convert.from_jax(jp, device=CPU), jp)


def _wathen_tiles_on_card(nx):
    """Wathen nx x nx (duplicates merged, diagonal dropped) as the card
    tile patterns of L and of U^T: M = A = L, B = U^T."""
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    lo, up = iu > ju, iu < ju
    return (gt.tile_pattern_from_coo(iu[lo], ju[lo], (n, n), device="cuda"),
            gt.tile_pattern_from_coo(ju[up], iu[up], (n, n), device="cuda"))


@pytest.mark.cuda
def test_k7_kernel_on_card():
    """The kernel against its plain version on the card: counting
    exactly (on the int8 tensor-core tile) on a random schedule of
    signed int8 tiles whose outputs take 0, 1 or up to 12 triples under
    a mask of bytes in -2..2, on the Wathen 128 schedule and on a random
    pattern; values within the float32 reassociation bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphblas_tpu_torch import _build
    rng = np.random.default_rng(9)
    A = torch.from_numpy(rng.integers(-128, 128, (40, 128, 128))
                         .astype(np.int8)).cuda()
    B = torch.from_numpy(rng.integers(-128, 128, (30, 128, 128))
                         .astype(np.int8)).cuda()
    M = torch.from_numpy(rng.integers(-2, 3, (20, 128, 128))
                         .astype(np.int8)).cuda()
    nout = 400
    cnt = rng.integers(0, 13, nout)
    cnt[:3] = (0, 1, 12)
    starts = np.zeros(nout + 1, np.int32)
    starts[1:] = np.cumsum(cnt)
    rand = [torch.from_numpy(x).cuda() for x in (
        starts, rng.integers(0, 40, starts[-1]).astype(np.int32),
        rng.integers(0, 30, starts[-1]).astype(np.int32),
        rng.integers(0, 20, nout).astype(np.int32))]
    before = _build.launches["bsr_masked_mm"]
    got = tcb.bsr_tiles_mm(*rand, A, B, M, torch.int32)
    torch.cuda.synchronize()
    assert _build.launches["bsr_masked_mm"] == before + 1
    assert torch.equal(got, tcb._bsr_mm_plain(*rand, A, B, M, torch.int32))
    assert not got[0].any()
    Lw, Bw = _wathen_tiles_on_card(128)
    sw = tcb._schedule(Lw, Lw, Bw)
    wargs = [torch.from_numpy(a).cuda() for a in sw[:4]]
    got = tcb.bsr_tiles_mm(*wargs, Lw.tiles, Bw.tiles, Lw.tiles, torch.int32)
    assert torch.equal(got, tcb._bsr_mm_plain(*wargs, Lw.tiles, Bw.tiles,
                                              Lw.tiles, torch.int32))
    assert int(got.sum(dtype=torch.int64)) == 884_992
    pat = _sym(1000, 0.01, 7)
    L, U = np.tril(pat, -1), np.triu(pat, 1)
    Lt = gt.tile_pattern(L, device="cuda")
    Ut = gt.tile_pattern(U, device="cuda")
    sched = tcb._schedule(Lt, Lt, Ut)
    args = [torch.from_numpy(a).cuda() for a in sched[:4]]
    got = tcb.bsr_tiles_mm(*args, Lt.tiles, Ut.tiles, Lt.tiles, torch.int32)
    want = tcb._bsr_mm_plain(*args, Lt.tiles, Ut.tiles, Lt.tiles,
                             torch.int32)
    assert torch.equal(got, want)
    rng = np.random.default_rng(8)
    Av = gt.tile_matrix(rng.normal(size=L.shape).astype(np.float32), L,
                        device="cuda")
    Bv = gt.tile_matrix(rng.normal(size=U.shape).astype(np.float32), U,
                        device="cuda")
    got = tcb.bsr_tiles_mm(*args, Av.tiles, Bv.tiles, Lt.tiles,
                           torch.float32)
    want = tcb._bsr_mm_plain(*args, Av.tiles.double(), Bv.tiles.double(),
                             Lt.tiles, torch.float64)
    mag = tcb._bsr_mm_plain(*args, Av.tiles.double().abs(),
                            Bv.tiles.double().abs(), Lt.tiles, torch.float64)
    kmax = sched[4]
    assert bool(((got.double() - want).abs()
                 <= kmax * 128 * 2.0 ** -24 * mag).all())
