"""PyTorch port, the tropical kernel K6 (``sparse/cuda_tropical.py``) and
the window masked-product kernel K3 (``window_masked_mm_pallas``):
their plain versions on the CPU, in parity with the JAX package.

The same numpy-seeded inputs go through the JAX function and the port's.
Tolerance: exact throughout.  Min and max are exact, a float32 add or
multiply is correctly rounded, and the window products are integer
counts, so the only freedom is the sign of a zero, which ``==`` does not
see.  The JAX Pallas kernels run in interpret mode at the small sizes
named in each test."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.core.semirings import semiring as jsemiring
from graphblas_tpu.ops import flopcount as jfc
from graphblas_tpu.ops.mxm import mxm as jmxm
from graphblas_tpu.sparse import pallas_tropical as jpt
from graphblas_tpu.sparse import pallas_window as jpw
from graphblas_tpu.sparse import window as jw
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import _build
from graphblas_tpu_torch.ops import mxm as tmxm
from graphblas_tpu_torch.sparse import cuda_tropical as ct
from graphblas_tpu_torch.sparse import cuda_window as cw

PAIRS = list(ct.TROPICAL_PAIRS)
ROUTED = [p for p in PAIRS if p[1] != "TIMES"]


def _equal(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal values, NaN where NaN (+0 == -0)."""
    return got.shape == want.shape and np.array_equal(got, want,
                                                      equal_nan=True)


def test_pairs_match_jax():
    assert ct.TROPICAL_PAIRS == jpt.TROPICAL_PAIRS
    for add in ("MIN", "MAX"):
        for dt in (np.float32, np.int32, np.uint8):
            assert ct._identity(add, np.dtype(dt)) == \
                jpt._identity(add, np.dtype(dt))


@pytest.mark.parametrize("add,mult", PAIRS)
def test_plain_matches_jax_kernel(add, mult):
    """The plain K6 against the Pallas kernel (interpret mode) at
    140x150x130: three 128-tiles deep with ragged edges, finite float32
    values, exact."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((140, 150)) * 4).astype(np.float32)
    b = (rng.standard_normal((150, 130)) * 4).astype(np.float32)
    want = np.asarray(jpt.tropical_mm(a, b, add, mult, interpret=True))
    got = ct.tropical_mm(torch.from_numpy(a), torch.from_numpy(b), add, mult)
    assert got.dtype == torch.float32
    assert _equal(got.numpy(), want)


def test_plain_takes_integers():
    """Like the JAX function, the plain version takes any dtype (the
    kernel takes float32 only)."""
    rng = np.random.default_rng(2)
    a = rng.integers(-50, 50, (20, 30)).astype(np.int32)
    b = rng.integers(-50, 50, (30, 10)).astype(np.int32)
    for add, mult in (("MIN", "PLUS"), ("MAX", "MIN")):
        want = np.asarray(jpt.tropical_mm(a, b, add, mult, interpret=True))
        got = ct.tropical_mm(torch.from_numpy(a), torch.from_numpy(b), add,
                             mult)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def _specials(rng, shape, frac=0.03):
    """Values in [-4, 4) with about ``frac`` each of +inf, -inf and NaN."""
    x = (rng.random(shape) * 8 - 4).astype(np.float32)
    u = rng.random(shape)
    x[u < frac] = np.inf
    x[(u >= frac) & (u < 2 * frac)] = -np.inf
    x[(u >= 2 * frac) & (u < 3 * frac)] = np.nan
    return x


@pytest.mark.parametrize("add,mult", ROUTED)
def test_route_matches_jax_generic(add, mult):
    """The route's identity fill and the plain K6, forced on CPU tensors,
    against the JAX package's generic path through ``gb.mxm`` (which its
    CPU backend takes), with +-inf and NaN in present values: the same
    pattern and values, exact."""
    rng = np.random.default_rng(3)
    Av, Bv = _specials(rng, (30, 40)), _specials(rng, (40, 25))
    Ap, Bp = rng.random((30, 40)) < 0.4, rng.random((40, 25)) < 0.4
    srj = jsemiring[f"{add}_{mult}".lower()][gb.FP32]
    srt = gt.semiring[f"{add}_{mult}".lower()][gt.FP32]
    Cj = jmxm(gb.Matrix.new(gb.FP32, 30, 25), None, None, srj,
              gb.Matrix.from_dense(Av, gb.FP32, pattern=Ap),
              gb.Matrix.from_dense(Bv, gb.FP32, pattern=Bp))
    assert jfc.last_axb_method() == "vpu:generic"
    vals, method = tmxm._tropical_values(
        srt, torch.from_numpy(np.where(Ap, Av, 0)), torch.from_numpy(Ap),
        torch.from_numpy(np.where(Bp, Bv, 0)), torch.from_numpy(Bp),
        gt.FP32, gt.FP32)
    assert method == f"torch:tropical_{add.lower()}_{mult.lower()}"
    assert gt.jax_engine_name(method) == \
        f"pallas:tropical_{add.lower()}_{mult.lower()}"
    pat = Cj.pattern_np()
    got = np.where(pat, vals.numpy(), 0)
    assert _equal(got, Cj.to_dense())
    # and the whole port on the CPU: the generic path, as in the JAX
    # package
    Ct = gt.mxm(gt.Matrix.new(gt.FP32, 30, 25, device="cpu"), None, None,
                srt, gt.Matrix.from_dense(Av, gt.FP32, pattern=Ap,
                                          device="cpu"),
                gt.Matrix.from_dense(Bv, gt.FP32, pattern=Bp, device="cpu"))
    assert gt.last_axb_method() == "vpu:generic"
    assert np.array_equal(Ct.pattern_np(), pat)
    assert _equal(Ct.to_dense(), Cj.to_dense())


def _defect_cases():
    """The two inputs on which the JAX kernel's NaN-propagating minimum
    differs from the generic path: (A values, A pattern, B values,
    B pattern, the generic path's answer)."""
    return [
        # +inf fill of the absent A[0,1] against a present -inf in B
        (np.array([[1.0, 0.0]], np.float32), np.array([[True, False]]),
         np.array([[5.0], [-np.inf]], np.float32), np.ones((2, 1), bool),
         6.0),
        # a NaN in a present value
        (np.array([[np.nan, 2.0]], np.float32), np.ones((1, 2), bool),
         np.array([[1.0], [3.0]], np.float32), np.ones((2, 1), bool), 5.0),
    ]


@pytest.mark.parametrize("case", [0, 1], ids=["opposite_inf", "nan_value"])
def test_reference_defects_not_copied(case):
    """min_plus[FP32] on the two defect inputs: the port's route (plain
    K6 on the filled operands) gives the generic path's 6.0 and 5.0, as
    the JAX ``gb.mxm`` does on its CPU backend; the JAX Pallas kernel on
    the same filled operands gives NaN (the reference defect, recorded
    here and in ROADMAP.md queue 3)."""
    Av, Ap, Bv, Bp, want = _defect_cases()[case]
    sr = gt.semiring.min_plus[gt.FP32]
    vals, _ = tmxm._tropical_values(sr, torch.from_numpy(Av),
                                    torch.from_numpy(Ap),
                                    torch.from_numpy(Bv),
                                    torch.from_numpy(Bp), gt.FP32, gt.FP32)
    assert float(vals[0, 0]) == want
    Cj = jmxm(gb.Matrix.new(gb.FP32, 1, 1), None, None,
              jsemiring.min_plus[gb.FP32],
              gb.Matrix.from_dense(Av, gb.FP32, pattern=Ap),
              gb.Matrix.from_dense(Bv, gb.FP32, pattern=Bp))
    assert Cj.extractElement(0, 0) == want
    a = np.where(Ap, Av, np.inf).astype(np.float32)
    b = np.where(Bp, Bv, np.inf).astype(np.float32)
    assert np.isnan(np.asarray(jpt.tropical_mm(a, b, "MIN", "PLUS",
                                               interpret=True))[0, 0])


def test_wrapper_checks():
    a, b = torch.zeros(3, 4), torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unsupported tropical pair"):
        ct.tropical_mm(a, b, "PLUS", "TIMES")
    with pytest.raises(ValueError):
        ct.tropical_mm(a, torch.zeros(5, 2))
    with pytest.raises(ValueError):
        ct.tropical_mm(a, b.double())
    out = ct.tropical_mm(torch.zeros(3, 0), torch.zeros(0, 2))
    assert torch.equal(out, torch.full((3, 2), float("inf")))


def _wathen_plan(nx):
    """The Wathen nx x nx window plan (M = L) in both packages."""
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    plans = []
    for pkg, csr, t in ((gt, lambda *a, **k: gt.csr_from_coo(
            *a, device="cpu", **k), gt.BOOL),
            (gb, gb.sparse.CsrMatrix.from_coo, gb.BOOL)):
        lo, up = iu > ju, iu < ju
        L = csr(iu[lo], ju[lo], np.ones(lo.sum(), bool), n, n, type=t,
                sum_duplicates=False)
        U = csr(iu[up], ju[up], np.ones(up.sum(), bool), n, n, type=t,
                sum_duplicates=False)
        mod = gt if pkg is gt else jw
        plans.append(mod.build_window_plan(L, U, L))
    return plans


def test_window_mm_matches_jax():
    """K3's plain version and the port's ``window_masked_mm`` against the
    JAX package's XLA ``window_masked_mm`` and the Pallas kernel
    (interpret mode) on the Wathen 6x6 window plan: int32, exact; the
    panels sum to the triangle count."""
    pt, pj = _wathen_plan(6)
    assert pt is not None and pj is not None
    want = np.asarray(jw.window_masked_mm(pj))
    assert np.array_equal(want, np.asarray(
        jpw.window_masked_mm_pallas(pj, interpret=True)))
    got = gt.window_masked_mm_pallas(pt)
    assert gt.last_axb_method() == "torch:window_mm"
    assert gt.jax_engine_name(gt.last_axb_method()) == "pallas:window_mm"
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(gt.window_masked_mm(pt), got)
    assert gt.last_axb_method() == "window:masked_mm"
    total = int(np.asarray(jw.window_masked_count_sum(pj)))
    assert total > 0
    assert int(got.sum()) == total
    assert int(gt.window_count_partials(pt).sum()) == total


def test_window_mm_rejects_bad_panels():
    pt, _ = _wathen_plan(6)
    pt.M = pt.M[:, :, :-128]
    with pytest.raises(ValueError):
        gt.window_masked_mm_pallas(pt)


@pytest.mark.cuda
def test_tropical_kernel_on_card():
    """K6 against its plain version on the card for all six pairs with
    +-inf and NaN values at ragged shapes, equal up to the sign of zero;
    each launch counted; a non-float32 CUDA tensor raises; the FP32
    min-plus ``mxm`` reports the kernel's engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    a = torch.from_numpy(_specials(rng, (130, 270))).cuda()
    b = torch.from_numpy(_specials(rng, (270, 200))).cuda()
    for add, mult in PAIRS:
        before = _build.launches["tropical_mm"]
        got = ct.tropical_mm(a, b, add, mult)
        torch.cuda.synchronize()
        assert _build.launches["tropical_mm"] == before + 1
        assert _equal(got.cpu().numpy(),
                      ct._tropical_mm_plain(a, b, add, mult).cpu().numpy())
    with pytest.raises(TypeError):
        ct.tropical_mm(a.double(), b.double())
    Av, Ap = _specials(rng, (30, 40)), rng.random((30, 40)) < 0.4
    A = gt.Matrix.from_dense(Av, gt.FP32, pattern=Ap, device="cuda")
    gt.mxm(gt.Matrix.new(gt.FP32, 30, 30, device="cuda"), None, None,
           "min_plus", A, A, gt.TRAN1)
    assert gt.last_axb_method() == "cuda:tropical_min_plus"


@pytest.mark.cuda
def test_window_mm_kernel_on_card():
    """K3 against its plain version on the card, exact, the launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pt, _ = _wathen_plan(6)
    pt.P, pt.Q, pt.M = pt.P.cuda(), pt.Q.cuda(), pt.M.cuda()
    before = _build.launches["window_mm"]
    got = gt.window_masked_mm_pallas(pt)
    torch.cuda.synchronize()
    assert _build.launches["window_mm"] == before + 1
    assert gt.last_axb_method() == "cuda:window_mm"
    assert torch.equal(got, cw._window_mm_plain(pt.P, pt.Q, pt.M))


@pytest.mark.cuda
@pytest.mark.parametrize("nJ", [128, 640])
@pytest.mark.parametrize("W", [128, 640])
@pytest.mark.parametrize("nI", [1, 3])
def test_window_mm_kernel_signed_panels_on_card(nI, W, nJ):
    """K3's int8 tensor-core tile against its plain version on random
    signed int8 panels (P, Q and M over the whole int8 range), exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from types import SimpleNamespace
    rng = np.random.default_rng(nI * 1000 + W + nJ)

    def panel(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape,
                                             dtype=np.int8)).cuda()

    plan = SimpleNamespace(P=panel(nI, 128, W), Q=panel(nI, W, nJ),
                           M=panel(nI, 128, nJ))
    before = _build.launches["window_mm"]
    got = gt.window_masked_mm_pallas(plan)
    torch.cuda.synchronize()
    assert _build.launches["window_mm"] == before + 1
    assert torch.equal(got, cw._window_mm_plain(plan.P, plan.Q, plan.M))
