"""PyTorch port, the value-panel engine's compacted rows
(``sparse/valdot.py``: ``ValRows``, ``compact_level``,
``valdot_gatherdot_rows`` and its plain version): parity with the dense
panels and with the JAX package.

A slab's compacted rows must re-expand to its dense panels exactly.  The
compacted gather-dot's plain version must equal the dense plain version
and the JAX package's fused Pallas gather-dot (interpret mode): int32
exactly (wrapping), float32 exactly on integer-valued inputs and within
the reassociation bound S * 2^-24 * sum|a * b| per lane of the float64
sum on random ones.  The masked valued product on the kernel route (the
gate forced open on the CPU, where the wrapper runs its plain version)
must equal the JAX package's, with the tolerance of
``tests/test_torch_valdot.py``.  The card-only tests hold the kernel to
its plain version on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import graphblas_tpu as gb
from graphblas_tpu.core.semirings import semiring as jsemiring
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import valdot as jvd
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import _build, convert
from graphblas_tpu_torch.sparse import valdot as tvd

from tests.test_torch_esc import assert_same_csr
from tests.test_torch_valdot import _lum, graph, min_lanes_1  # noqa: F401


def _sparse_panel(r, n, S, dtype, density, lo=-3, hi=4):
    """An (n, S) panel of integer-valued entries, each row with its own
    density (some rows empty), as numpy."""
    P = r.integers(lo, hi, (n, S)).astype(dtype)
    keep = r.random((n, S)) < r.random((n, 1)) * 2 * density
    P = np.where(keep, P, 0).astype(dtype)
    P[:3] = 0                                   # empty rows
    return P


_rows_of = tvd.compact_panel


def _expand(R: tvd.ValRows, S: int) -> torch.Tensor:
    """The dense (nrows, S) panel of compacted rows, scattered as the
    plan scatters a slab's entries."""
    n = R.ptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=R.ptr.device),
                                   (R.ptr[1:] - R.ptr[:-1]).long())
    return tvd._pack_vals(n, S, rows, R.slot, R.val)


def _lanes(r, na, nb, E, sorted_rows=True):
    ai = r.integers(-1, na, E).astype(np.int32)
    if sorted_rows:
        ai.sort()                               # runs of one A row
    bj = r.integers(0, nb, E).astype(np.int32)
    bj[::17] = -1                               # clipped to row 0
    return torch.from_numpy(ai), torch.from_numpy(bj)


@pytest.mark.parametrize("dtype,tname", [(np.float32, "FP32"),
                                         (np.int32, "INT32"),
                                         (np.float64, "FP64")])
def test_compact_level_round_trip(graph, dtype, tname):
    """Every slab's compacted rows re-expand to its dense value panels,
    exactly, and each row's slots ascend."""
    _, (Lt, Ut, Mt) = _lum(graph, dtype, tname)
    sr = gt.semiring.plus_times[getattr(gt, tname)]
    plan = tvd.build_valdot_plan(Mt, Lt, Ut, sr, min_lanes=1, level_cols=64)
    assert plan is not None and len(plan.levels) > 1
    for lv in plan.levels:
        Av, Bv, _, _ = tvd._pack_level(lv, bits=False)
        Ar, Br = tvd.compact_level(lv)
        assert Ar.slot.numel() == int((lv.a_slots >= 0).sum())
        assert Br.slot.numel() == int((lv.b_slots >= 0).sum())
        for R, P in ((Ar, Av), (Br, Bv)):
            assert R.ptr.dtype == R.slot.dtype == torch.int32
            assert R.val.dtype == P.dtype
            assert torch.equal(_expand(R, lv.S), P)
            assert int(R.ptr[-1]) == R.slot.numel() == R.val.numel()
            row = torch.repeat_interleave(torch.arange(P.shape[0]),
                                          (R.ptr[1:] - R.ptr[:-1]).long())
            key = row * lv.S + R.slot.long()
            assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_rows_plain_matches_dense_and_pallas_interpret(dtype):
    """The compacted plain version against the dense plain version and
    the JAX package's fused Pallas gather-dot in interpret mode (one
    128-lane step of it: S = 4096 takes 128 rows per step), on integer
    values, so both dtypes compare exactly: a padded list, nlive < E, -1
    indices, empty rows and rows with no common slot."""
    r = np.random.default_rng(11)
    na, nb, S = 96, 80, 4096
    Av = _sparse_panel(r, na, S, dtype, 0.05)
    Bv = _sparse_panel(r, nb, S, dtype, 0.05)
    # rows 3 and 4 of A and B meet in no slot
    Av[3, :S // 2] = 1
    Bv[4, S // 2:] = 2
    Av[3, S // 2:] = Bv[4, :S // 2] = 0
    E, nlive = 128, 101
    ai, bj = _lanes(r, na, nb, E)
    ai[:5], bj[:5] = 3, 4
    want = np.asarray(jvd._pallas_gatherdot(
        jnp.asarray(Av.reshape(na, 8, S // 8)),
        jnp.asarray(Bv.reshape(nb, 8, S // 8)), jnp.asarray(ai.numpy()),
        jnp.asarray(bj.numpy()), nlive, interpret=True))
    A, B = torch.from_numpy(Av), torch.from_numpy(Bv)
    before = dict(_build.launches)
    got = tvd.valdot_gatherdot_rows(_rows_of(A), _rows_of(B), ai, bj, nlive,
                                    S)
    assert _build.launches == before         # CPU: the plain version
    dense = tvd._gatherdot_plain(A, B, ai, bj, nlive)
    assert got.dtype == dense.dtype == torch.from_numpy(want).dtype
    assert torch.equal(got, dense)
    assert np.array_equal(got.numpy()[:nlive], want[:nlive])
    assert not got[nlive:].any()
    assert not got[:5].any()                   # no common slot


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_rows_plain_float32_within_bound(sorted_rows):
    """Random float32 values: each lane within S * 2^-24 * sum|a * b| of
    the float64 sum; the dense plain version too."""
    r = np.random.default_rng(12)
    na, nb, S, E, nlive = 70, 60, 256, 2000, 1900
    A = torch.from_numpy(np.where(r.random((na, S)) < 0.1,
                                  r.random((na, S)) - 0.5, 0)
                         .astype(np.float32))
    B = torch.from_numpy(np.where(r.random((nb, S)) < 0.2,
                                  r.random((nb, S)) - 0.5, 0)
                         .astype(np.float32))
    ai, bj = _lanes(r, na, nb, E, sorted_rows)
    got = tvd.valdot_gatherdot_rows(_rows_of(A), _rows_of(B), ai, bj, nlive,
                                    S)
    a = A[ai[:nlive].long().clamp(0, na - 1)].double()
    b = B[bj[:nlive].long().clamp(0, nb - 1)].double()
    err = (got[:nlive].double() - (a * b).sum(1)).abs()
    bound = S * 2.0 ** -24 * (a * b).abs().sum(1)
    assert bool((err <= bound).all())
    assert not got[nlive:].any()
    dense = tvd._gatherdot_plain(A, B, ai, bj, nlive)
    assert bool(((got - dense).abs()[:nlive].double() <= 2 * bound).all())


def test_rows_int32_wraps():
    """int32 products and sums wrap, as the dense version's do."""
    A = torch.zeros((2, 8), dtype=torch.int32)
    B = torch.zeros((3, 8), dtype=torch.int32)
    A[:, ::2] = 1 << 20
    B[:, ::2] = 1 << 20
    B[1, 1] = 7
    ai = torch.tensor([0, 1, 5, 1], dtype=torch.int32)
    bj = torch.tensor([2, -1, 0, 1], dtype=torch.int32)
    got = tvd.valdot_gatherdot_rows(_rows_of(A), _rows_of(B), ai, bj, 4, 8)
    want = tvd._gatherdot_plain(A, B, ai, bj, 4)
    assert torch.equal(got, want)
    assert got.tolist()[:3] == [0, 0, 0]       # 4 * 2^40 wraps to 0


def test_rows_edge_cases(monkeypatch):
    """nlive of 0 and past the length, a panel with no entries, and the
    plain version's chunking (at most _CHUNK_PAIRS pairs per chunk)."""
    r = np.random.default_rng(13)
    S = 64
    A = torch.from_numpy(_sparse_panel(r, 30, S, np.float32, 0.3))
    B = torch.from_numpy(_sparse_panel(r, 20, S, np.float32, 0.3))
    Ar, Br = _rows_of(A), _rows_of(B)
    ai, bj = _lanes(r, 30, 20, 500)
    assert not tvd.valdot_gatherdot_rows(Ar, Br, ai, bj, 0, S).any()
    full = tvd.valdot_gatherdot_rows(Ar, Br, ai, bj, 10 ** 6, S)
    assert torch.equal(full, tvd._gatherdot_plain(A, B, ai, bj, 500))
    empty = _rows_of(torch.zeros_like(A))
    assert not tvd.valdot_gatherdot_rows(empty, Br, ai, bj, 500, S).any()
    assert not tvd.valdot_gatherdot_rows(Ar, _rows_of(torch.zeros_like(B)),
                                         ai, bj, 500, S).any()
    monkeypatch.setattr(tvd, "_CHUNK_PAIRS", 7)
    assert torch.equal(tvd.valdot_gatherdot_rows(Ar, Br, ai, bj, 10 ** 6, S),
                       full)


def test_rows_wrapper_checks():
    A = _rows_of(torch.eye(4, 8))
    B = _rows_of(torch.eye(5, 8))
    i = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        tvd.valdot_gatherdot_rows(A, B, i, i, 3, 6)
    with pytest.raises(TypeError, match="float32 or int32"):
        tvd.valdot_gatherdot_rows(A._replace(val=A.val.double()),
                                  B._replace(val=B.val.double()), i, i, 3, 8)
    with pytest.raises(TypeError, match="differ"):
        tvd.valdot_gatherdot_rows(A, B._replace(val=B.val.int()), i, i, 3, 8)
    with pytest.raises(TypeError, match="int32"):
        tvd.valdot_gatherdot_rows(A, B, i.long(), i, 3, 8)
    with pytest.raises(TypeError, match="int32"):
        tvd.valdot_gatherdot_rows(A._replace(slot=A.slot.long()), B, i, i,
                                  3, 8)
    with pytest.raises(ValueError, match="differ in length"):
        tvd.valdot_gatherdot_rows(A._replace(val=A.val[:-1]), B, i, i, 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tvd.valdot_gatherdot_rows(
            A._replace(val=torch.zeros(2 * A.val.numel())[::2]), B, i, i, 3,
            8)


@pytest.mark.parametrize("dtype,tname", [(np.float32, "FP32"),
                                         (np.int32, "INT32")])
def test_kernel_route_matches_jax(graph, min_lanes_1, monkeypatch, dtype,
                                  tname):
    """With the kernel gate open (on the CPU the wrapper runs its plain
    version), the plan caches compacted rows and no value panel, and the
    masked product equals the JAX package's, engine name included."""
    (Lj, Uj, Mj), (Lt, Ut, Mt) = _lum(graph, dtype, tname)
    monkeypatch.setattr(tvd, "_use_kernel", lambda *a: True)
    srj = jsemiring.plus_times[getattr(gb, tname)]
    srt = convert.from_jax(srj)
    Ct = tvd.valdot_masked_spgemm(srt, Lt, Ut, Mt)
    Cj = jvd.valdot_masked_spgemm(srj, Lj, Uj, Mj)
    assert gt.jax_engine_name(gt.last_axb_method()) == jax_last_method()
    assert_same_csr(Ct, Cj)
    plan = tvd.cached_plan(Mt, Lt, Ut, srt)
    assert all(lv.rows is not None and lv.packed is None
               for lv in plan.levels)


def _card_rows_case(r, S, dt, E, runs):
    na, nb = 900, 700
    if dt == torch.float32:
        A = torch.from_numpy(np.where(r.random((na, S)) < 0.04,
                                      r.random((na, S)) - 0.5, 0)
                             .astype(np.float32))
        B = torch.from_numpy(np.where(r.random((nb, S)) < 0.04,
                                      r.random((nb, S)) - 0.5, 0)
                             .astype(np.float32))
    else:
        A = torch.from_numpy(_sparse_panel(r, na, S, np.int32, 0.04,
                                           -2 ** 31, 2 ** 31 - 1))
        B = torch.from_numpy(_sparse_panel(r, nb, S, np.int32, 0.04,
                                           -2 ** 31, 2 ** 31 - 1))
    ai = r.integers(-1, runs or na, E).astype(np.int32)
    if runs:
        ai.sort()                # runs of about E / runs lanes
    bj = r.integers(-1, nb, E).astype(np.int32)
    return (A.cuda(), B.cuda(), torch.from_numpy(ai).cuda(),
            torch.from_numpy(bj).cuda())


@pytest.mark.cuda
def test_gatherdot_rows_kernel_on_card():
    """The compacted kernel against its plain version on the card, one
    launch counted per call: int32 exactly, float32 within S * 2^-24 *
    sum|a * b| of the float64 sum; long runs and runs of about 22 lanes
    (staged A rows), unsorted lanes (runs of one: searched A rows) and a
    slab wider than the staged row (S = 16384, searched throughout); 0
    past nlive."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = np.random.default_rng(21)
    for S in (1024, 16384):
        for dt in (torch.float32, torch.int32):
            for runs in (9, 900, None):
                A, B, ai, bj = _card_rows_case(r, S, dt, 20_000, runs)
                E, nlive = ai.numel(), 19_001
                Ar, Br = _rows_of(A), _rows_of(B)
                before = _build.launches["valdot_gatherdot_rows"]
                got = tvd.valdot_gatherdot_rows(Ar, Br, ai, bj, nlive, S)
                torch.cuda.synchronize()
                assert _build.launches["valdot_gatherdot_rows"] == before + 1
                want = tvd._gatherdot_rows_plain(Ar, Br, ai, bj, nlive, S)
                assert not got[nlive:].any() and got.shape == (E,)
                if dt == torch.int32:
                    assert torch.equal(got, want)
                    continue
                a = A[ai[:nlive].long().clamp(0, A.shape[0] - 1)].double()
                b = B[bj[:nlive].long().clamp(0, B.shape[0] - 1)].double()
                bound = S * 2.0 ** -24 * (a * b).abs().sum(1)
                assert bool(((got[:nlive].double() - (a * b).sum(1)).abs()
                             <= bound).all())


@pytest.mark.cuda
def test_gatherdot_rows_raises_on_card():
    """On the card a float64 or narrow-slab input raises and launches
    nothing; it never runs the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = _rows_of(torch.eye(4, 8, device="cuda"))
    B = _rows_of(torch.eye(5, 8, device="cuda"))
    i = torch.zeros(3, dtype=torch.int32, device="cuda")
    before = dict(_build.launches)
    with pytest.raises(TypeError, match="float32 or int32"):
        tvd.valdot_gatherdot_rows(A._replace(val=A.val.double()),
                                  B._replace(val=B.val.double()), i, i, 3, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        tvd.valdot_gatherdot_rows(A, B, i, i, 3, 6)
    with pytest.raises(ValueError, match="is on"):
        tvd.valdot_gatherdot_rows(A, B, i.cpu(), i.cpu(), 3, 8)
    assert _build.launches == before
