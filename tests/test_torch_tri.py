"""PyTorch port, sort-merge counting and triangle-count entry points
(sparse/tri.py): parity with the JAX package.

Random graphs made with numpy from a seed go through both packages on
the CPU; per-entry counts, filtered containers and triangle counts must
be equal (exactly: all integers), and agree with a dense oracle."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.sparse import tri as jtri
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.ops.flopcount import entry_lanes
from graphblas_tpu_torch.sparse import tri as ttri
from graphblas_tpu_torch.utils import counters


def _sym(seed, n, nedges):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, nedges)
    j = rng.integers(0, n, nedges)
    keep = i != j
    i, j = i[keep], j[keep]
    lin = np.unique(np.concatenate([i * n + j, j * n + i]))
    return lin // n, lin % n


def _both(I, J, n, m=None, typ="BOOL"):
    m = n if m is None else m
    X = np.ones(len(I), bool)
    tt = getattr(gt, typ)
    jt = getattr(gb, typ)
    return (gt.csr_from_coo(I, J, X, n, m, type=tt, sum_duplicates=False,
                            device="cpu"),
            jsp.CsrMatrix.from_coo(I, J, X, n, m, type=jt,
                                   sum_duplicates=False))


def _same_csr(At, Aj):
    assert (At.nvals, At.nzmax, At.shape) == (Aj.nvals, Aj.nzmax, Aj.shape)
    for a, b in ((At.indptr, Aj.indptr), (At.indices, Aj.indices),
                 (At.rowids, Aj.rowids)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(At.values.numpy(),
                          At.type.to_storage(np.asarray(Aj.values)))


def _dense_tricount(n, I, J):
    A = np.zeros((n, n), np.int64)
    A[I, J] = 1
    return int(np.trace(A @ A @ A)) // 6


@pytest.mark.parametrize("seed,n,nedges", [(0, 60, 300), (1, 300, 3000)])
def test_prep_matches_jax(seed, n, nedges):
    I, J = _sym(seed, n, nedges)
    At, Aj = _both(I, J, n)
    (Lt, Ut), (Lj, Uj) = (ttri.tricount_prep_csr(At),
                          jtri.tricount_prep_csr(Aj))
    _same_csr(Lt, Lj)
    _same_csr(Ut, Uj)
    for a, b in zip(Lt._options["host_pattern"],
                    Lj._options["host_pattern"]):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("seed,n,nedges", [(0, 60, 300), (1, 300, 3000),
                                           (2, 500, 6000)])
def test_masked_pair_counts_matches_jax(seed, n, nedges):
    I, J = _sym(seed, n, nedges)
    At, Aj = _both(I, J, n)
    (Lt, Ut), (Lj, Uj) = (ttri.tricount_prep_csr(At),
                          jtri.tricount_prep_csr(Aj))
    got = ttri.masked_pair_counts(Lt, Lt, Ut)
    want = np.asarray(jtri.masked_pair_counts(Lj, Lj, Uj))
    assert got.dtype == torch.int32 and got.shape == (Lt.nzmax,)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == _dense_tricount(n, I, J)


@pytest.mark.parametrize("slice_mask", [True, False])
def test_split_blocks_match_jax(slice_mask):
    # more lanes than the smallest block cap (2^14), so a tiny chunk
    # splits A into several flop-balanced blocks
    I, J = _sym(3, 300, 4000)
    At, Aj = _both(I, J, 300)
    if not slice_mask:
        # a filtered copy keeps no host pattern: its blocks slice the
        # mask by rows all the same, with the same reads
        At = ttri.csr_filter_lanes(At, torch.ones(At.nzmax, dtype=bool))
        Aj = jtri.csr_filter_lanes(Aj, np.ones(Aj.nzmax, bool))
    flops = int(entry_lanes(At, At).sum())
    assert flops > 4 * (1 << 14)
    counters.reset()
    counters.trace_spans(True)
    try:
        got = ttri.masked_pair_counts(At, At, At, chunk=1)
    finally:
        counters.trace_spans(False)
    st = counters.stats()
    assert st["counts"]["reads"] == 3
    assert {name: sp["count"] for name, sp in st["spans"].items()
            if name.startswith("gb.read.")} == {
        "gb.read.sort_merge_lanes": 1, "gb.read.sort_merge_blocks": 1,
        "gb.read.sort_merge_mask_slices": 1}
    whole = ttri.masked_pair_counts(At, At, At)
    want = np.asarray(jtri.masked_pair_counts(Aj, Aj, Aj, chunk=1))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, whole)


def test_rectangular_and_dimension_mismatch():
    rng = np.random.default_rng(4)

    def pattern(m, n, k):
        lin = np.unique(rng.integers(0, m * n, k))
        return _both(lin // n, lin % n, m, n)

    A, B = pattern(30, 50, 200), pattern(50, 40, 200)
    M = pattern(30, 40, 300)
    got = ttri.masked_pair_counts(M[0], A[0], B[0])
    want = np.asarray(jtri.masked_pair_counts(M[1], A[1], B[1]))
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(gt.DimensionMismatch):
        ttri.masked_pair_counts(A[0], A[0], B[0])


@pytest.mark.parametrize("k", [-1, 0, 2])
def test_tril_triu_filter_match_jax(k):
    I, J = _sym(5, 80, 600)
    At, Aj = _both(I, J, 80, typ="UINT32")
    _same_csr(ttri.csr_tril(At, k), jtri.csr_tril(Aj, k))
    _same_csr(ttri.csr_triu(At, -k), jtri.csr_triu(Aj, -k))
    keep = np.random.default_rng(k + 10).random(At.nzmax) < 0.5
    _same_csr(ttri.csr_filter_lanes(At, torch.from_numpy(keep)),
              jtri.csr_filter_lanes(Aj, keep))


@pytest.mark.parametrize("seed,n,nedges", [(6, 120, 800), (7, 400, 5000)])
def test_tricount_esc_and_device_match_jax(seed, n, nedges):
    I, J = _sym(seed, n, nedges)
    At, Aj = _both(I, J, n)
    (Lt, Ut), (Lj, Uj) = (ttri.tricount_prep_csr(At),
                          jtri.tricount_prep_csr(Aj))
    want = _dense_tricount(n, I, J)
    assert ttri.tricount_esc(Lt, Ut) == jtri.tricount_esc(Lj, Uj) == want
    dev = ttri.tricount_device(Lt, Ut)
    assert dev.dtype == torch.int64 and dev.dim() == 0 and int(dev) == want
    # the pure-Sandia form (L·L).<L counts each triangle once too
    assert ttri.tricount_esc(Lt) == jtri.tricount_esc(Lj)


def test_tricount_empty_graph():
    e = np.zeros(0, np.int64)
    L = gt.csr_from_coo(e, e, np.zeros(0, bool), 10, 10, device="cpu")
    assert ttri.tricount_esc(L, L) == 0
    assert int(ttri.masked_pair_counts(L, L, L).abs().sum()) == 0
