"""PyTorch port, band/window plans and the band-ring / window-count
kernels' plain versions: parity with the JAX package.

The same banded graphs, made with numpy from a seed, build plans in both
packages; the panels must be equal, and the port's per-block partials
(the kernels' plain PyTorch versions on the CPU) must equal the JAX
package's Pallas kernels run in interpret mode.  Exact equality: every
quantity is an integer."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.sparse import pallas_window as jpw
from graphblas_tpu.sparse import window as jw
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert
from graphblas_tpu_torch.ops.flopcount import jax_engine_name


def _banded_lu(n, bw, density, seed):
    rng = np.random.default_rng(seed)
    sym = rng.random((n, n)) < density
    band = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= bw
    Ap = (sym | sym.T) & band
    np.fill_diagonal(Ap, False)
    out = {}
    for name, pat in (("L", np.tril(Ap)), ("U", np.triu(Ap))):
        I, J = np.nonzero(pat)
        X = np.ones(len(I), bool)
        out[name] = (gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL,
                                     device="cpu"),
                     jsp.csr_from_coo(I, J, X, n, n, type=gb.BOOL))
    return out["L"], out["U"], Ap


# (n, band width, density, seed): the JAX window test's graph, and a
# wider band whose plan has Wb >= 4 blocks
GRAPHS = [(700, 90, 0.15, 0), (1200, 420, 0.03, 1)]


@pytest.fixture(scope="module", params=GRAPHS, ids=["bw90", "wb4"])
def graph(request):
    n, bw, density, seed = request.param
    (Lt, Lj), (Ut, Uj), Ap = _banded_lu(n, bw, density, seed)
    Af = Ap.astype(np.float64)
    want = int(round(((Af @ Af) * Af).sum())) // 6
    return Lt, Lj, Ut, Uj, want


def test_band_plan_matches_jax(graph):
    Lt, Lj, Ut, Uj, _ = graph
    pt, pj = gt.build_band_plan(Lt, Ut), jw.build_band_plan(Lj, Uj)
    assert pt is not None and pj is not None
    assert (pt.nI, pt.Wb, pt.ntriples, pt.nedges) == \
        (pj.nI, pj.Wb, pj.ntriples, pj.nedges)
    assert np.array_equal(pt.P.numpy(), np.asarray(pj.P))
    assert np.array_equal(pt.Ut.numpy(), np.asarray(pj.Ut))
    assert pt.panel_bytes == pj.panel_bytes


def test_window_plan_matches_jax(graph):
    Lt, Lj, Ut, Uj, _ = graph
    pt, pj = gt.build_window_plan(Lt, Ut, Lt), jw.build_window_plan(Lj, Uj, Lj)
    assert pt is not None and pj is not None
    assert (pt.nI, pt.Wmax, pt.nJmax, pt.ntriples) == \
        (pj.nI, pj.Wmax, pj.nJmax, pj.ntriples)
    for a, b in ((pt.P, pj.P), (pt.Q, pj.Q), (pt.M, pj.M)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(pt.k0, pj.k0) and np.array_equal(pt.j0, pj.j0)


def test_band_partials_match_jax_kernel(graph):
    Lt, Lj, Ut, Uj, want = graph
    got = gt.tricount_band_partials(gt.build_band_plan(Lt, Ut))
    assert gt.last_axb_method() == "torch:tri_band_ring"
    ref = np.asarray(jpw.tricount_band_partials(jw.build_band_plan(Lj, Uj)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert int(got.sum(dtype=torch.int64)) == want
    assert jax_engine_name(gt.last_axb_method()) == "pallas:tri_band_ring"


def test_window_partials_match_jax_kernel(graph):
    Lt, Lj, Ut, Uj, want = graph
    got = gt.window_count_partials(gt.build_window_plan(Lt, Ut, Lt))
    assert gt.last_axb_method() == "torch:window_count"
    ref = np.asarray(jpw.window_count_partials(
        jw.build_window_plan(Lj, Uj, Lj)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert int(got.sum(dtype=torch.int64)) == want
    assert jax_engine_name(gt.last_axb_method()) == "pallas:window_count"


def test_window_count_sum_and_tricount_window(graph):
    Lt, Lj, Ut, Uj, want = graph
    assert gt.tricount_window(Lt, Ut) == jw.tricount_window(Lj, Uj) == want
    assert gt.last_axb_method() == "window:count_sum"


def test_convert_roundtrips_jax_plans(graph):
    Lt, Lj, Ut, Uj, want = graph
    bj = jw.build_band_plan(Lj, Uj)
    bt = convert.from_jax(bj, device="cpu")
    assert (bt.nI, bt.Wb, bt.ntriples) == (bj.nI, bj.Wb, bj.ntriples)
    assert np.array_equal(bt.Ut.numpy(), np.asarray(bj.Ut))
    assert int(gt.tricount_band_partials(bt).sum()) == want
    wj = jw.build_window_plan(Lj, Uj, Lj)
    wt = convert.from_jax(wj, device="cpu")
    assert (wt.Wmax, wt.nJmax, wt.shape) == (wj.Wmax, wj.nJmax, wj.shape)
    assert int(gt.window_count_partials(wt).sum()) == want


def test_plans_refuse_unstructured():
    n = 128 * (gt.sparse.window.MAX_W_BLOCKS + 2)
    rng = np.random.default_rng(4)
    I, J = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    lo = I > J
    L = gt.csr_from_coo(I[lo], J[lo], np.ones(lo.sum(), bool), n, n,
                        device="cpu")
    U = L.T()
    assert gt.build_band_plan(L, U) is None
    assert gt.build_window_plan(L, U, L) is None
    assert gt.tricount_window(L, U) is None


@pytest.mark.parametrize("which", ["band", "window"])
def test_wrappers_reject_bad_panels(which):
    (Lt, _), (Ut, _), _ = _banded_lu(300, 40, 0.2, 5)
    if which == "band":
        plan = gt.build_band_plan(Lt, Ut)
        plan.P = plan.P.to(torch.int32)
        fn = gt.tricount_band_partials
    else:
        plan = gt.build_window_plan(Lt, Ut, Lt)
        plan.Q = plan.Q[:, :-128]
        fn = gt.window_count_partials
    with pytest.raises((TypeError, ValueError)):
        fn(plan)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    # without the CUDA toolkit the kernel build raises; nothing falls
    # back to the plain version for a CUDA tensor
    from graphblas_tpu_torch import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
