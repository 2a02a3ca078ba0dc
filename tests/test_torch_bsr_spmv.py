"""PyTorch port, the BSR SpMV engine (K5): parity with the JAX package.

Mirrors the Pallas BSR group of ``test_sparse.py`` (``:502-643``).  The
JAX kernel runs in interpret mode, the port's wrapper runs the kernel's
plain PyTorch version (CPU tensors).  The plan arrays (rb, cb, slot,
valid, tiles) must be equal; y values agree within the per-row
reassociation bound 2 * K * 2^-24 * sum_c |a_rc * x_c| (K: the row's
term count; each package is within K * 2^-24 * sum of the exact sum),
patterns exactly.  The kernel itself runs only on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import pallas_spmv as ps
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import _build, convert
from graphblas_tpu_torch.sparse import cuda_spmv as cs

SRJ = gb.semiring.plus_times[gb.FP32]
SRT = gt.semiring.plus_times[gt.FP32]


def _both(I, J, X, m, n, **kw):
    Aj = jsp.CsrMatrix.from_coo(I, J, X, m, n, type=gb.FP32, **kw)
    return Aj, convert.from_jax(Aj, device="cpu")


def _bound(At, x):
    """Per-row 2 * K * 2^-24 * sum |a * x| (and the float64 product)."""
    I, J, X = At.extractTuples()
    m = At.nrows
    exact = np.zeros(m)
    np.add.at(exact, I, X.astype(np.float64) * x[J])
    mag = np.zeros(m)
    np.add.at(mag, I, np.abs(X.astype(np.float64) * x[J]))
    K = np.maximum(np.bincount(I, minlength=m), 1)
    return exact, 2 * K * 2.0 ** -24 * mag


def _check_y(yt, pt, yj, pj, At, x):
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    yt, yj = yt.numpy(), np.asarray(yj)
    exact, tol = _bound(At, x)
    assert np.all(np.abs(yt - yj) <= tol + 1e-30)
    assert np.all(np.abs(yt - exact) <= tol / 2 + 1e-30)


def _plans_equal(Aj, At):
    pj = ps.bsr_spmv_plan(Aj)
    pt = cs.bsr_spmv_plan(At)
    for name, a, b in zip(("rb", "cb", "slot", "valid", "tiles"), pj[:5],
                          pt[:5]):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        assert np.array_equal(a, b.numpy()), name
    assert tuple(pj[5:]) == (pt.nrb, pt.ncb, pt.ntiles)
    rb = pt.rb.numpy()
    assert np.array_equal(pt.rbptr.numpy(),
                          np.searchsorted(rb, np.arange(pt.nrb + 1)))
    return pt


@pytest.mark.parametrize("m,n,nz", [(300, 450, 4000), (129, 127, 900),
                                    (64, 64, 500), (700, 260, 9000)])
def test_bsr_spmv_matches_jax(m, n, nz):
    """``test_sparse.py:502``: plan arrays equal, y within the bound."""
    rng = np.random.default_rng(7 + m)
    I = rng.integers(0, m, nz)
    J = rng.integers(0, n, nz)
    X = rng.normal(size=nz).astype(np.float32)
    Aj, At = _both(I, J, X, m, n)
    x = rng.normal(size=n).astype(np.float32)
    yj, pj = ps.bsr_spmv(SRJ, Aj, jnp.asarray(x), interpret=True)
    yt, pt = cs.bsr_spmv(SRT, At, torch.from_numpy(x))
    assert gt.last_axb_method() == "torch:bsr_spmv"
    assert gt.jax_engine_name(gt.last_axb_method()) == jax_last_method()
    _check_y(yt, pt, yj, pj, At, x)
    _plans_equal(Aj, At)
    assert ("_bsr_spmv_plan", 128, "<f4") in At._options


def test_bsr_spmv_empty_row_blocks_zeroed():
    """``test_sparse.py:526``: row-blocks with no tiles give zeros (the
    plan's dummy invalid triples)."""
    rng = np.random.default_rng(8)
    m, n = 600, 300
    I = np.concatenate([rng.integers(0, 100, 800),
                        rng.integers(400, 450, 300)])
    J = rng.integers(0, n, len(I))
    X = rng.normal(size=len(I)).astype(np.float32)
    Aj, At = _both(I, J, X, m, n)
    x = rng.normal(size=n).astype(np.float32)
    yj, pj = ps.bsr_spmv(SRJ, Aj, jnp.asarray(x), interpret=True)
    yt, pt = cs.bsr_spmv(SRT, At, torch.from_numpy(x))
    _check_y(yt, pt, yj, pj, At, x)
    assert np.all(yt.numpy()[128:384] == 0)
    plan = _plans_equal(Aj, At)
    # blocks 1 and 2 own one invalid triple each
    for rb in (1, 2):
        lo, hi = plan.rbptr[rb:rb + 2].tolist()
        assert hi - lo == 1 and int(plan.valid[lo]) == 0
    # the plain tile pass writes zeros for them too (no stale values)
    xpad = torch.zeros(plan.ncb * 128)
    xpad[:n] = torch.from_numpy(x)
    assert torch.all(cs.bsr_spmv_tiles(plan, xpad)[128:384] == 0)


def test_bsr_spmv_gate():
    """``test_sparse.py:550``: the gate routes only dense-enough f32
    PLUS_TIMES; on the CPU only when forced."""
    rng = np.random.default_rng(9)
    I = rng.integers(0, 100, 2000)
    J = rng.integers(0, 100, 2000)
    ones = np.ones(2000, np.float32)
    for force in (True, None, False):
        Aj, At = _both(I, J, ones, 100, 100)
        if force is not None:
            Aj._options["bsr_spmv"] = force
            At._options["bsr_spmv"] = force
        assert cs.bsr_spmv_ok(SRT, At) == ps.bsr_spmv_ok(SRJ, Aj) \
            == (force is True)
    assert At._options.get(("_bsr_spmv_ok", 128)) is None
    Aj, At = _both(I, J, ones, 100, 100)
    At._options["bsr_spmv"] = True
    assert cs.bsr_spmv_ok(SRT, At)
    assert At._options[("_bsr_spmv_ok", 128)] is True
    # ~1 entry per 128x128 tile: rejected
    ri = rng.permutation(4096)[:1000]
    rj = rng.permutation(4096)[:1000]
    Bj, Bt = _both(ri, rj, np.ones(1000, np.float32), 4096, 4096)
    Bj._options["bsr_spmv"] = Bt._options["bsr_spmv"] = True
    assert not cs.bsr_spmv_ok(SRT, Bt) and not ps.bsr_spmv_ok(SRJ, Bj)
    # wrong semiring / type: rejected
    assert not cs.bsr_spmv_ok(gt.semiring.min_plus[gt.FP32], At)
    assert not cs.bsr_spmv_ok(gt.semiring.plus_times[gt.FP64], At)
    # the automatic route off the CPU: a matrix whose tensors are not on
    # the CPU passes the device test with no option set (the gate reads
    # only the host pattern; "meta" stands in for the card here)
    _, Ct = _both(I, J, ones, 100, 100)
    Ct.indices = Ct.indices.to("meta")
    assert Ct._options.get("bsr_spmv") is None
    assert cs.bsr_spmv_ok(SRT, Ct) is True


def test_bsr_spmv_gate_tile_budget(monkeypatch):
    """The memory guard: a plan over MAX_TILE_BYTES is refused."""
    rng = np.random.default_rng(2)
    I = rng.integers(0, 512, 20000)
    J = rng.integers(0, 512, 20000)
    Aj, At = _both(I, J, np.ones(20000, np.float32), 512, 512)
    monkeypatch.setattr(cs, "MAX_TILE_BYTES", 15 * 128 * 128 * 4)
    monkeypatch.setattr(ps, "MAX_TILE_BYTES", 15 * 128 * 128 * 4)
    Aj._options["bsr_spmv"] = At._options["bsr_spmv"] = True
    assert not cs.bsr_spmv_ok(SRT, At) and not ps.bsr_spmv_ok(SRJ, Aj)


def test_bsr_spmv_sums_duplicates():
    """``test_sparse.py:587``: duplicate (i, j) lanes of a container built
    with sum_duplicates=False add up in the tiles."""
    I = np.array([0, 0, 5, 5, 5, 130, 130])
    J = np.array([3, 3, 7, 7, 7, 2, 2])
    X = np.array([1.0, 2.0, 10.0, 20.0, 30.0, 4.0, 5.0], np.float32)
    Aj, At = _both(I, J, X, 200, 200, sum_duplicates=False)
    x = np.arange(1, 201, dtype=np.float32)
    y, _ = cs.bsr_spmv(SRT, At, torch.from_numpy(x))
    y = y.numpy()
    assert y[0] == 3.0 * x[3] and y[5] == 60.0 * x[7] and y[130] == 9.0 * x[2]
    yj, _ = ps.bsr_spmv(SRJ, Aj, jnp.asarray(x), interpret=True)
    assert np.array_equal(y, np.asarray(yj))
    _plans_equal(Aj, At)


def test_bsr_spmv_plan_dimension_independent():
    """``test_sparse.py:606``: a 2^23-dimension matrix with three dense
    clusters plans without a grid-sized table."""
    dim = 1 << 23
    rng = np.random.default_rng(11)
    base = np.array([0, dim // 2, dim - 128], np.int64)
    I = np.concatenate([b + rng.integers(0, 128, 2000) for b in base])
    J = np.concatenate([b + rng.integers(0, 128, 2000) for b in base])
    X = rng.normal(size=len(I)).astype(np.float32)
    At = gt.csr_from_coo(I, J, X, dim, dim, type=gt.FP32, device="cpu")
    plan = cs.bsr_spmv_plan(At)
    assert plan.ntiles <= 12 and plan.tiles.shape[0] == plan.ntiles
    assert plan.rbptr.shape[0] == plan.nrb + 1


def test_csr_mxv_routes_to_bsr_spmv():
    """``test_sparse.py:624``: csr_mxv sends a qualifying dense-x call to
    the tile engine and records it; the opt-out takes the dense-x
    engine with the same result."""
    rng = np.random.default_rng(10)
    m = n = 200
    I = rng.integers(0, m, 5000)
    J = rng.integers(0, n, 5000)
    X = rng.normal(size=5000).astype(np.float32)
    Aj, At = _both(I, J, X, m, n)
    Aj._options["bsr_spmv"] = At._options["bsr_spmv"] = True
    x = rng.normal(size=n).astype(np.float32)
    yj, pj = jsp.csr_mxv(SRJ, Aj, jnp.asarray(x))
    assert jax_last_method() == "pallas:bsr_spmv"
    yt, pt = gt.csr_mxv(SRT, At, x)
    assert gt.last_axb_method() == "torch:bsr_spmv"
    _check_y(yt, pt, yj, pj, At, x)
    At._options["bsr_spmv"] = False
    y2, p2 = gt.csr_mxv(SRT, At, x)
    assert gt.last_axb_method() == "spmv:dense_x"
    assert torch.equal(p2, pt)
    _, tol = _bound(At, x)
    assert np.all(np.abs(y2.numpy() - yt.numpy()) <= tol + 1e-30)


def test_mxv_dense_vector_routes_to_bsr_spmv():
    """gt.mxv with a dense u (every entry present) reaches the tile
    engine; a u with a pattern takes the sparse-x engine."""
    rng = np.random.default_rng(12)
    I = rng.integers(0, 256, 6000)
    J = rng.integers(0, 256, 6000)
    X = rng.normal(size=6000).astype(np.float32)
    Aj, At = _both(I, J, X, 256, 256)
    At._options["bsr_spmv"] = True
    x = rng.normal(size=256).astype(np.float32)
    u = gt.Vector.from_dense(x, device="cpu")
    w = gt.mxv(gt.Vector.new(gt.FP32, 256, device="cpu"), None, None,
               "plus_times", At, u)
    assert gt.last_axb_method() == "torch:bsr_spmv"
    yj, pj = ps.bsr_spmv(SRJ, Aj, jnp.asarray(x), interpret=True)
    _check_y(torch.from_numpy(w.to_dense()), w.pattern, yj, pj, At, x)
    up = gt.Vector.from_dense(x, pattern=np.arange(256) % 3 > 0,
                              device="cpu")
    gt.mxv(gt.Vector.new(gt.FP32, 256, device="cpu"), None, None,
           "plus_times", At, up)
    assert gt.last_axb_method() == "spmv:sparse_x"


def test_plan_from_jax_arrays():
    rng = np.random.default_rng(13)
    I = rng.integers(0, 300, 3000)
    J = rng.integers(0, 200, 3000)
    Aj, At = _both(I, J, rng.normal(size=3000).astype(np.float32), 300, 200)
    pc = convert.from_jax(ps.bsr_spmv_plan(Aj), device="cpu")
    pt = cs.bsr_spmv_plan(At)
    for a, b in zip(pc, pt):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_tiles_wrapper_checks_inputs():
    rng = np.random.default_rng(14)
    I = rng.integers(0, 130, 900)
    J = rng.integers(0, 130, 900)
    _, At = _both(I, J, np.ones(900, np.float32), 130, 130)
    plan = cs.bsr_spmv_plan(At)
    with pytest.raises(ValueError):
        cs.bsr_spmv_tiles(plan, torch.zeros(130))
    with pytest.raises(TypeError):
        cs.bsr_spmv_tiles(plan, torch.zeros(256, dtype=torch.float64))
    with pytest.raises(TypeError):
        cs.bsr_spmv_tiles(plan._replace(cb=plan.cb.long()),
                          torch.zeros(256))


@pytest.mark.cuda
def test_bsr_spmv_kernel_on_card():
    """The kernel against its plain version on the card, within the
    per-row bound, and the launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(15)
    m, n, nz = 1000, 700, 60000
    I = np.concatenate([rng.integers(0, 300, nz), rng.integers(700, m, nz)])
    J = rng.integers(0, n, len(I))
    X = rng.normal(size=len(I)).astype(np.float32)
    At = gt.csr_from_coo(I, J, X, m, n, type=gt.FP32, device="cuda")
    plan = cs.bsr_spmv_plan(At)
    xpad = torch.zeros(plan.ncb * 128, device="cuda")
    xpad[:n] = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    before = _build.launches["bsr_spmv"]
    got = cs.bsr_spmv_tiles(plan, xpad)
    torch.cuda.synchronize()
    assert _build.launches["bsr_spmv"] == before + 1
    want = cs._bsr_spmv_plain(plan._replace(tiles=plan.tiles.double()),
                              xpad.double())
    mag = cs._bsr_spmv_plain(plan._replace(tiles=plan.tiles.abs().double()),
                             xpad.abs().double())
    deg = torch.zeros(plan.nrb * 128, dtype=torch.float64, device="cuda")
    deg[:m] = (At.indptr[1:] - At.indptr[:-1]).double().clamp(min=1)
    assert bool(((got.double() - want).abs()
                 <= deg * 2.0 ** -24 * mag).all())
    assert bool((got[384:640] == 0).all())     # empty row-blocks 3, 4
