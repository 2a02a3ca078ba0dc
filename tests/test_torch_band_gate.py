"""PyTorch port, the band and window planners on containers made on the
device: ``tricount_auto(csr_tril(A, k), csr_triu(A, -k))``, as
``tri_demo`` counts.

``csr_tril``/``csr_triu`` keep no host pattern, so the planners copy
the live lanes back once a container (the count
``plan.pattern_from_device``, the read ``gb.read.plan_pattern``) and
cache the plan or the refusal.  Wathen meshes must count on the band
ring, equal to the sort-merge and to the JAX package, from the same
plan a host pattern gives; graphs wider than the band must cache both
refusals, so a warm call copies nothing back."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.sparse import tri as jtri
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.utils import counters

NX = [8, 16, 32, 64]
KS = [-1, -2]


def _both(I, J, n):
    X = np.ones(len(I), bool)
    return (gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL,
                            sum_duplicates=False, device="cpu"),
            jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                   sum_duplicates=False))


def _wathen(nx):
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    key = np.unique(I * n + J)
    return _both(key // n, key % n, n)


def _split(A, k):
    """L, U of ``A`` on its device, as ``tri_demo`` splits it."""
    return gt.csr_tril(A, k), gt.csr_triu(A, -k)


def _urand(n=4096, deg=6, seed=5):
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, n, n * deg // 2), rng.integers(0, n, n * deg // 2)
    keep = i != j
    key = np.unique(np.concatenate([i[keep] * n + j[keep],
                                    j[keep] * n + i[keep]]))
    return _both(key // n, key % n, n)


def _rmat(scale=12):
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    return _both(*gt.symmetrize_pattern(I, J, n), n)


@pytest.fixture(autouse=True)
def _clean_counts():
    counters.reset()
    yield
    counters.reset()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nx", NX)
def test_tril_triu_count_reaches_band_ring(nx, k):
    At, Aj = _wathen(nx)
    L, U = _split(At, k)
    got = gt.tricount_auto(L, U)
    assert gt.last_axb_method() == "torch:tri_band_ring"
    want = jtri.tricount_auto(jtri.csr_tril(Aj, k), jtri.csr_triu(Aj, -k))
    assert got == gt.tricount_esc(L, U) == want > 0
    # the copy is the planners' own: the other engines' gates are as before
    assert "host_pattern" not in L._options
    assert "host_pattern" not in U._options


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nx", NX)
def test_band_plan_from_device_pattern_equals_host(nx, k):
    At, _ = _wathen(nx)
    L, U = _split(At, k)
    dev = gt.build_band_plan(L, U)
    host = []
    for X in (L, U):
        r, c = X.rowids[:X.nvals].numpy(), X.indices[:X.nvals].numpy()
        host.append(gt.csr_from_coo(r, c, np.ones(len(r), bool), X.nrows,
                                    X.ncols, type=gt.BOOL,
                                    sum_duplicates=False, device="cpu"))
    ref = gt.build_band_plan(*host)
    assert dev is not None and ref is not None
    assert (dev.nI, dev.Wb, dev.ntriples, dev.nedges) == (
        ref.nI, ref.Wb, ref.ntriples, ref.nedges)
    assert torch.equal(dev.P, ref.P) and torch.equal(dev.Ut, ref.Ut)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nx", NX)
def test_pattern_copied_at_plan_build_only(nx, k):
    At, _ = _wathen(nx)
    L, U = _split(At, k)
    want = gt.tricount_esc(L, U)
    counters.reset()
    for call in range(4):
        assert gt.tricount_auto(L, U) == want
        counts = counters.stats()["counts"]
        if call == 0:
            assert counts["plan.pattern_from_device"] == 2
            assert counts["plan.band.built"] == 1
        else:
            assert counts == {"reads": 1, "plan.band.reused": 1}
        counters.reset()


@pytest.mark.parametrize("make", [_urand, _rmat], ids=["urand4096", "rmat12"])
def test_wide_graph_caches_both_refusals(make):
    At, Aj = make()
    L, U = _split(At, -1)
    counters.trace_spans(True)
    try:
        got = gt.tricount_auto(L, U)
        cold = counters.stats()["counts"]
        # the window plan reads L twice and U again: one copy a container
        assert cold["plan.pattern_from_device"] == 2
        assert cold["plan.band.built"] == cold["plan.window.built"] == 1
        assert gt.tricount_window(L, U) is None
        counters.reset()
        assert gt.tricount_auto(L, U) == got
        warm = counters.stats()["counts"]
        reads = [r.name for r in counters.span_records()
                 if r.name.startswith("gb.read.")]
    finally:
        counters.trace_spans(False)
    assert warm["plan.band.reused"] == warm["plan.window.reused"] == 1
    assert "plan.pattern_from_device" not in warm
    assert "gb.read.plan_pattern" not in reads
    assert got == jtri.tricount_auto(jtri.csr_tril(Aj, -1),
                                     jtri.csr_triu(Aj, 1))
