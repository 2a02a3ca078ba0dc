"""PyTorch port, bitpacked popcount engine (sparse/bitdot.py, bitpack.py):
parity with the JAX package.

Graphs and panels are made with numpy from a seed and go through both
packages on the CPU; the port runs the popcount kernel's plain PyTorch
version there.  Exact equality: packed words compare as the same 32-bit
patterns, counts as integers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.sparse import bitpack as jbp
from graphblas_tpu.sparse import tri as jtri
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import bitdot as tbd
from graphblas_tpu_torch.sparse import bitpack as tbp


def _powerlaw(seed, n=600, alpha=1.2, mult=3):
    """The JAX bitdot test's power-law graph, prepped in both packages."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(alpha, n) * mult).astype(int) + 1, n - 1)
    I = np.repeat(np.arange(n), deg)
    J = rng.integers(0, n, size=len(I))
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    I, J = lin // n, lin % n
    X = np.ones(len(I), bool)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)
    return gt.tricount_prep_csr(At), jtri.tricount_prep_csr(Aj)


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def test_words_for_and_pack_pattern():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 300):
        assert tbp.words_for(n) == jbp.words_for(n)
        pat = rng.random((17, n)) < 0.3
        got = tbp.pack_pattern(pat, device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), _u32(jbp.pack_pattern(pat)))


def test_popcount_swar_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, -2**31, 2**31 - 1]
    got = tbp.popcount(torch.from_numpy(x))
    want = np.asarray(jbp.popcount(jnp.asarray(x.view(np.uint32))))
    assert np.array_equal(got.numpy(), want)
    got64 = tbp.popcount(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got64.numpy(), want)


def test_pack_matches_jax_pack():
    rng = np.random.default_rng(2)
    nrows, W = 50, 16
    cells = rng.choice(nrows * W * 32, 3000, replace=False)
    rows = (cells // (W * 32)).astype(np.int32)
    slots = (cells % (W * 32)).astype(np.int32)
    slots[::7] = -1                          # padding slots set no bit
    got = tbd._pack(nrows, W, torch.from_numpy(rows),
                    torch.from_numpy(slots))
    want = jbd._pack_jit(nrows, W, jnp.asarray(rows), jnp.asarray(slots),
                         jnp.asarray(slots >= 0))
    assert np.array_equal(got.numpy(), _u32(want))


@pytest.mark.parametrize("seed", [3, 11])
def test_plan_panels_match_jax(seed):
    (Lt, Ut), (Lj, Uj) = _powerlaw(seed)
    pt = tbd.build_bitdot_plan(Lt, Lt, Ut, min_lanes=1, cover_target=0.8)
    pj = jbd.build_bitdot_plan(Lj, Lj, Uj, min_lanes=1, cover_target=0.8)
    assert pt is not None and pj is not None
    assert (pt.W, pt.kcut, pt.covered_lanes, pt.light_lanes) == \
        (pj.W, pj.kcut, pj.covered_lanes, pj.light_lanes)
    assert len(pt.levels) == len(pj.levels)
    assert np.array_equal(pt.Apack.numpy(), _u32(pj.Apack))
    assert np.array_equal(pt.Bpack.numpy(), _u32(pj.Bpack))
    for lt, lj in zip(pt.levels, pj.levels):
        assert (lt.W, lt.na, lt.nb, lt.covered) == \
            (lj.W, lj.na, lj.nb, lj.covered)
        for a, b in ((lt.amap, lj.amap), (lt.bmap, lj.bmap)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b))
    assert pt.A_light.nvals == pj.A_light.nvals
    assert pt.A_light.nzmax == pj.A_light.nzmax
    assert np.array_equal(pt.A_light.indices.numpy(),
                          np.asarray(pj.A_light.indices))


@pytest.mark.parametrize("maps", [False, True])
@pytest.mark.parametrize("W", [8, 40])
def test_bitdot_pass_matches_jax(maps, W):
    rng = np.random.default_rng(W + maps)
    m, n, na, nb = 90, 70, 40, 30
    A = rng.integers(0, 2**32, (na if maps else m, W), dtype=np.uint64)
    B = rng.integers(0, 2**32, (nb if maps else n, W), dtype=np.uint64)
    A, B = A.astype(np.uint32), B.astype(np.uint32)
    amap = bmap = None
    if maps:
        amap = rng.integers(-1, na, m).astype(np.int32)
        bmap = rng.integers(-1, nb, n).astype(np.int32)
    I = rng.integers(0, m, 600)
    J = rng.integers(0, n, 600)
    X = np.ones(600, bool)
    Mt = gt.csr_from_coo(I, J, X, m, n, device="cpu")
    Mj = jsp.csr_from_coo(I, J, X, m, n)
    tm = (lambda a: None if a is None else torch.from_numpy(a))
    jm = (lambda a: None if a is None else jnp.asarray(a))
    got = tbd._bitdot_pass(torch.from_numpy(A.view(np.int32)),
                           torch.from_numpy(B.view(np.int32)),
                           tm(amap), tm(bmap), Mt)
    want = jbd._bitdot_pass(jnp.asarray(A), jnp.asarray(B), jm(amap),
                            jm(bmap), Mj)
    assert got.dtype == torch.int32 and got.shape == (Mt.nzmax,)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got[Mt.nvals:].abs().sum()) == 0


def test_popcount_wrapper_checks_inputs():
    A = torch.zeros((4, 8), dtype=torch.int32)
    r = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        gt.bitdot_popcount(A.long(), A, None, None, r, r, 5)
    with pytest.raises(ValueError):
        gt.bitdot_popcount(A, torch.zeros((4, 16), dtype=torch.int32),
                           None, None, r, r, 5)
    with pytest.raises(ValueError):
        gt.bitdot_popcount(A, A[:, ::2], None, None, r, r, 5)


@pytest.mark.parametrize("seed", [3, 11])
def test_hybrid_matches_jax_and_sort_merge(seed):
    (Lt, Ut), (Lj, Uj) = _powerlaw(seed)
    pt = tbd.build_bitdot_plan(Lt, Lt, Ut, min_lanes=1, cover_target=0.8)
    got = tbd.bitdot_counts(pt, Lt) + gt.masked_pair_counts(Lt, pt.A_light,
                                                           Ut)
    pj = jbd.build_bitdot_plan(Lj, Lj, Uj, min_lanes=1, cover_target=0.8)
    want = jbd.bitdot_counts(pj, Lj) + jtri.masked_pair_counts(
        Lj, pj.A_light, Uj)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(),
                          gt.masked_pair_counts(Lt, Lt, Ut).numpy())


def test_full_coverage_no_residual():
    (Lt, Ut), (Lj, Uj) = _powerlaw(5, n=300)
    pt = tbd.build_bitdot_plan(Lt, Lt, Ut, min_lanes=1, cover_target=1.0)
    pj = jbd.build_bitdot_plan(Lj, Lj, Uj, min_lanes=1, cover_target=1.0)
    assert pt.A_light.nvals == pj.A_light.nvals == 0
    assert np.array_equal(tbd.bitdot_counts(pt, Lt).numpy(),
                          np.asarray(jbd.bitdot_counts(pj, Lj)))


@pytest.mark.parametrize("seed,n,budget,levels", [
    (7, 400, None, 1), (13, 500, None, 1), (3, 600, 1 << 16, 3)])
def test_masked_pair_counts_auto_matches_jax(monkeypatch, seed, n, budget,
                                             levels):
    # tiny graphs: let every wedge count, and let extra slabs pay, so a
    # small budget splits the heavy columns over several levels
    for mod in (tbd, jbd):
        monkeypatch.setattr(mod, "_MIN_LANES", 1)
        monkeypatch.setattr(mod, "_MIN_LEVEL_REM", 1)
        monkeypatch.setattr(mod, "_MIN_LEVEL_COVER", 1)
    (Lt, Ut), (Lj, Uj) = _powerlaw(seed, n=n)
    got = tbd.masked_pair_counts_auto(Lt, Lt, Ut, budget_bytes=budget)
    engine = gt.last_axb_method()
    want = jbd.masked_pair_counts_auto(Lj, Lj, Uj, budget_bytes=budget)
    assert engine == jax_last_method()
    assert engine.startswith("bitdot:")
    assert len(Lt._options["bitdot_plan"][2].levels) == levels
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the plan is cached on the mask and reused
    entry = Lt._options["bitdot_plan"]
    again = tbd.masked_pair_counts_auto(Lt, Lt, Ut, budget_bytes=budget)
    assert Lt._options["bitdot_plan"] is entry
    assert torch.equal(again, got)


def test_small_graph_falls_back_to_sort_merge():
    I = np.array([1, 2, 2, 3, 3, 3])
    J = np.array([0, 0, 1, 0, 1, 2])
    L = gt.csr_from_coo(I, J, np.ones(6, bool), 4, 4, device="cpu")
    U = gt.csr_from_coo(J, I, np.ones(6, bool), 4, 4, device="cpu")
    assert tbd.build_bitdot_plan(L, L, U) is None
    got = tbd.masked_pair_counts_auto(L, L, U)
    assert gt.last_axb_method() == "tri:sort_merge"
    assert int(got.sum()) == 4          # K4 has 4 triangles


# ---- the popcount pass over compacted B rows ----

def _sparse_words(rng, shape, density=0.3):
    """Random 32-bit words, about ``density`` of them nonzero, with a few
    all-zero rows."""
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    w[rng.random(shape) >= density] = 0
    w[::7] = 0
    return w


def _popcount_case(W, maps=True, order="random", long_row=0, seed=0):
    """Random panels and mask entries as numpy arrays: (Apack, Bpack,
    amap, bmap, rowids, indices, nvals).  ``maps`` adds row maps with -1
    rows; ``order`` "sorted" gives CSR-ordered rowids (runs of one A
    row), "random" unsorted; ``long_row`` > 0 makes row 0 that many
    entries long; the last 5 % of the entries lie past nvals."""
    rng = np.random.default_rng(seed + W)
    m, n, na, nb, E = 80, 70, 60, 50, 700 + long_row
    A = _sparse_words(rng, (na, W))
    B = _sparse_words(rng, (nb, W))
    amap = bmap = None
    if maps:
        amap = rng.integers(-1, na, m).astype(np.int32)
        bmap = rng.integers(-1, nb, n).astype(np.int32)
        amap[0] = 1               # the long row has an A row
    rows = rng.integers(0, m if maps else na, E).astype(np.int32)
    rows[:long_row] = 0
    if order == "sorted":
        rows.sort()
    cols = rng.integers(0, n if maps else nb, E).astype(np.int32)
    return A, B, amap, bmap, rows, cols, E - E // 20


def _torch_case(case, device="cpu"):
    return tuple(None if x is None else torch.from_numpy(x).to(device)
                 for x in case[:6]) + (case[6],)


def _jax_bitdot(case):
    A, B, amap, bmap, rows, cols, nvals = case
    dummy = jnp.zeros((1,), jnp.int32)
    return np.asarray(jbd._bitdot_jit(
        1, rows.shape[0], amap is not None, bmap is not None,
        jnp.asarray(A.view(np.uint32)), jnp.asarray(B.view(np.uint32)),
        dummy if amap is None else jnp.asarray(amap),
        dummy if bmap is None else jnp.asarray(bmap),
        jnp.asarray(rows), jnp.asarray(cols), nvals))


def _scatter_back(Bc, nrows, W):
    ptr = Bc.ptr.long()
    rows = torch.repeat_interleave(torch.arange(nrows), ptr[1:] - ptr[:-1])
    dense = torch.zeros((nrows, W), dtype=torch.int32)
    dense[rows, Bc.widx.long()] = Bc.word
    return dense, rows


@pytest.mark.parametrize("W", [1, 37, 1024])
def test_compact_rows_scatters_back(W):
    panel = torch.from_numpy(_sparse_words(np.random.default_rng(W),
                                           (45, W)))
    Bc = tbd.compact_rows(panel)
    assert all(x.dtype == torch.int32 for x in Bc)
    assert int(Bc.ptr[0]) == 0 and int(Bc.ptr[-1]) == Bc.word.numel()
    assert Bc.word.numel() == int((panel != 0).sum())
    assert bool((Bc.word != 0).all())
    dense, rows = _scatter_back(Bc, 45, W)
    assert torch.equal(dense, panel)
    key = rows * W + Bc.widx.long()          # row-major, columns ascending
    assert bool((key[1:] > key[:-1]).all())


def test_compact_rows_of_empty_panel():
    Bc = tbd.compact_rows(torch.zeros((6, 9), dtype=torch.int32))
    assert Bc.ptr.tolist() == [0] * 7 and Bc.word.numel() == 0


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("maps", [False, True])
@pytest.mark.parametrize("W", [1, 37, 1024])
def test_compact_plain_matches_dense_plain_and_jax(W, maps, order):
    """The compacted-B plain version equals the dense plain version and
    the JAX ``_bitdot_jit`` exactly: maps with -1 rows, unsorted or
    sorted rowids, entries past nvals."""
    case = _popcount_case(W, maps, order)
    args = _torch_case(case)
    Bc = tbd.compact_rows(args[1])
    got = tbd._bitdot_popcount_compact_plain(args[0], Bc, *args[2:])
    dense = tbd._bitdot_popcount_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, dense)
    assert np.array_equal(got.numpy(), _jax_bitdot(case))
    assert int(got[case[6]:].abs().sum()) == 0
    assert int(got.sum()) > 0


@pytest.mark.parametrize("seed", [3, 11])
def test_plan_caches_compacted_level1_b(seed):
    """The plan's compacted B is its level-1 Bpack's, and the compacted
    plain version over the power-law graph's mask equals the JAX pass."""
    (Lt, Ut), (Lj, Uj) = _powerlaw(seed)
    pt = tbd.build_bitdot_plan(Lt, Lt, Ut, min_lanes=1, cover_target=0.8)
    pj = jbd.build_bitdot_plan(Lj, Lj, Uj, min_lanes=1, cover_target=0.8)
    dense, _ = _scatter_back(pt.Bcomp, pt.Bpack.shape[0], pt.W)
    assert torch.equal(dense, pt.Bpack)
    lv = pt.levels[0]
    got = tbd._bitdot_popcount_compact_plain(
        pt.Apack, pt.Bcomp, lv.amap, lv.bmap, Lt.rowids, Lt.indices,
        Lt.nvals)
    want = jbd._bitdot_pass(pj.Apack, pj.Bpack, pj.levels[0].amap,
                            pj.levels[0].bmap, Lj)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_popcount_wrapper_checks_compacted_rows():
    A = torch.zeros((4, 8), dtype=torch.int32)
    r = torch.zeros(5, dtype=torch.int32)
    Bc = tbd.compact_rows(A)
    with pytest.raises(ValueError):
        tbd._check_compact(Bc, 5, A.device)
    with pytest.raises(TypeError):
        tbd._check_compact(Bc._replace(word=Bc.word.long()), 4, A.device)
    # on the CPU the wrapper runs the dense plain version, Bcomp or not
    assert torch.equal(gt.bitdot_popcount(A, A, None, None, r, r, 5, Bc),
                       torch.zeros(5, dtype=torch.int32))


@pytest.mark.parametrize("seed", [3, 11])
def test_tricount_and_ktruss_match_jax(seed):
    (Lt, Ut), (Lj, Uj) = _powerlaw(seed)
    assert gt.tricount_esc(Lt, Ut) == int(jtri.tricount_esc(Lj, Uj))
    rng = np.random.default_rng(seed)
    n = 400
    I = rng.integers(0, n, 4000)
    J = rng.integers(0, n, 4000)
    I, J = gt.symmetrize_pattern(I, J, n)
    At = gt.csr_from_coo(I, J, np.ones(len(I), bool), n, n, type=gt.BOOL,
                         sum_duplicates=False, device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                                type=gb.BOOL, sum_duplicates=False)
    Ct, _, st = gt.ktruss_esc(At, 4)
    Cj, _, sj = jtri.ktruss_esc(Aj, 4)
    assert (Ct.nvals, st) == (Cj.nvals, sj)
    assert np.array_equal(Ct.indices[:Ct.nvals].numpy(),
                          np.asarray(Cj.indices[:Cj.nvals]))


_CARD_CASES = ([(W, maps, order, 0) for W in (1, 37, 1024)
                for maps in (False, True) for order in ("random", "sorted")]
               + [(1024, True, "sorted", 600), (648, False, "sorted", 1500),
                  (12000, True, "sorted", 300)])


@pytest.mark.cuda
@pytest.mark.parametrize("W,maps,order,long_row", _CARD_CASES)
def test_popcount_kernel_on_card(W, maps, order, long_row):
    """The kernel against both plain versions on the card, exactly: the
    CPU cases, a mask row longer than one chunk of entries (256), and a
    row too wide to stage in shared memory (W = 12000); one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphblas_tpu_torch import _build
    args = _torch_case(_popcount_case(W, maps, order, long_row), "cuda")
    Bc = tbd.compact_rows(args[1])
    before = _build.launches["bitdot_popcount"]
    got = gt.bitdot_popcount(*args, Bcomp=Bc)
    torch.cuda.synchronize()
    assert _build.launches["bitdot_popcount"] == before + 1
    assert torch.equal(got, tbd._bitdot_popcount_plain(*args))
    assert torch.equal(got, tbd._bitdot_popcount_compact_plain(
        args[0], Bc, *args[2:]))
    # bare panels: the wrapper compacts B itself
    assert torch.equal(gt.bitdot_popcount(*args), got)
