"""PyTorch port: OOM fault-injection sweeps (mirror of
``test_faultinject.py``) — the reference's malloc-debug protocol on the
port's container-materialization checkpoints (``utils/faultinject.py``):

  for k = 1, 2, ...:  arm(k); run op
      -> OutOfMemory: inputs must be bit-identical and valid; retry
      -> success:     result must equal the clean (uninjected) run

The port's containers hold tensors that an operation could write in
place, and shallow copies share them, so "inputs unchanged" is a real
check here: the snapshots compare every stored tensor of each input.
The same ops run through the JAX package's sweep, and each package's
result must equal its clean run; the port's clean result must equal
the JAX one (exact patterns, values within rtol 1e-5 for FP32 and
1e-12 for FP64, the reassociation tolerance of the products).
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core.errors import OutOfMemory as JaxOutOfMemory
from graphblas_tpu.utils import faultinject as jfi
from graphblas_tpu_torch.core.errors import Info, OutOfMemory
from graphblas_tpu_torch.sparse import (CsrMatrix, HyperMatrix, csr_spgemm,
                                        hyper_from_coo, hyper_spgemm)
from graphblas_tpu_torch.utils import faultinject

DEV = "cpu"


def rand_dense(m, n, density, dtype, seed=0):
    rng = np.random.default_rng(seed)
    pat = rng.random((m, n)) < density
    vals = rng.standard_normal((m, n)).astype(dtype)
    return vals, pat


def rand_matrix(m, n, density, t, seed=0):
    vals, pat = rand_dense(m, n, density, t.dtype, seed)
    return gt.Matrix.from_dense(vals, t, pattern=pat, device=DEV)


def _tensors(A):
    """Every tensor a container holds (its stored arrays and values)."""
    if isinstance(A, (gt.Matrix, gt.Vector)):
        return [A.pattern, *_leaves(A.values)]
    if isinstance(A, HyperMatrix):
        return [A.h, A.hptr, A.rowids, A.indices, *_leaves(A.values)]
    if isinstance(A, CsrMatrix):
        return [A.indptr, A.indices, A.rowids, *_leaves(A.values)]
    raise TypeError(type(A))


def _leaves(v):
    return [x for k in sorted(v) for x in _leaves(v[k])] \
        if isinstance(v, dict) else [v]


def _snapshot(A):
    """Bit-image of a container's stored tensors."""
    return [t.clone() for t in _tensors(A)]


def _assert_same(snap, A):
    for s, g in zip(snap, _tensors(A)):
        assert s.dtype == g.dtype and s.shape == g.shape
        assert torch.equal(s.view(torch.uint8) if s.dtype.is_complex
                           else s, g.view(torch.uint8)
                           if g.dtype.is_complex else g), \
            "an input changed across an injected fault"


def _sweep(op, inputs, compare, max_k=60, fi=faultinject,
           oom=OutOfMemory, snap=_snapshot, same=_assert_same):
    """The reference's loop-until-success: returns (#faults, result)."""
    clean = op()  # uninjected baseline
    snaps = [snap(a) for a in inputs]
    faults = 0
    for k in range(1, max_k + 1):
        fi.set_fault_countdown(k)
        try:
            got = op()
        except oom:
            faults += 1
            for s, a in zip(snaps, inputs):
                same(s, a)
            continue
        finally:
            fi.clear_fault()
        compare(clean, got)
        for s, a in zip(snaps, inputs):
            same(s, a)
        return faults, got
    raise AssertionError(f"op still failing after {max_k} checkpoints")


def _jax_sweep(op, compare):
    return _sweep(op, [], compare, fi=jfi, oom=JaxOutOfMemory)


def _cmp_matrix(a, b):
    np.testing.assert_allclose(np.asarray(a.to_dense()),
                               np.asarray(b.to_dense()), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.pattern_np()),
                                  np.asarray(b.pattern_np()))


def _cmp_tuples(a, b):
    for x, y in zip(a.extractTuples(), b.extractTuples()):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5)


def test_mxm_bitmap_oom_sweep():
    Ad, Ap = rand_dense(12, 12, 0.4, np.float32, seed=1)
    Bd, Bp = rand_dense(12, 12, 0.4, np.float32, seed=2)
    A = gt.Matrix.from_dense(Ad, gt.FP32, pattern=Ap, device=DEV)
    B = gt.Matrix.from_dense(Bd, gt.FP32, pattern=Bp, device=DEV)
    op = lambda: gt.mxm(gt.Matrix.new(gt.FP32, 12, 12, device=DEV), None,
                        None, gt.semiring.plus_times[gt.FP32], A, B)
    faults, got = _sweep(op, [A, B], _cmp_matrix)
    assert faults >= 1  # the countdown actually fired at least once
    Aj = gb.Matrix.from_dense(Ad, gb.FP32, pattern=Ap)
    Bj = gb.Matrix.from_dense(Bd, gb.FP32, pattern=Bp)
    jfaults, want = _jax_sweep(
        lambda: gb.mxm(gb.Matrix.new(gb.FP32, 12, 12), None, None,
                       gb.semiring.plus_times[gb.FP32], Aj, Bj), _cmp_matrix)
    assert jfaults >= 1
    _cmp_matrix(got, want)


def _rand_coo(seed, n, nnz):
    rng = np.random.default_rng(seed)
    I, J = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    return I, J, rng.standard_normal(nnz).astype(np.float32)


def test_csr_spgemm_oom_sweep():
    from graphblas_tpu import sparse as jsp
    n = 40
    I, J, X = _rand_coo(3, n, 160)
    A = CsrMatrix.from_coo(I, J, X, n, n, device=DEV)
    op = lambda: csr_spgemm(gt.semiring.plus_times[gt.FP32], A, A)
    faults, got = _sweep(op, [A], _cmp_tuples)
    assert faults >= 1
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n)
    jfaults, want = _jax_sweep(
        lambda: jsp.csr_spgemm(gb.semiring.plus_times[gb.FP32], Aj, Aj),
        _cmp_tuples)
    assert jfaults >= 1
    _cmp_tuples(got, want)


def test_masked_csr_mxm_oom_sweep():
    """The masked product on CSR (the facade's main path: valdot with
    the ESC residual, or ESC alone), inputs and mask unchanged."""
    n = 48
    I, J, X = _rand_coo(11, n, 400)
    A = CsrMatrix.from_coo(I, J, X, n, n, device=DEV)
    Im, Jm, Xm = _rand_coo(12, n, 300)
    M = CsrMatrix.from_coo(Im, Jm, np.ones(len(Im), np.float32), n, n,
                           device=DEV)
    e = np.zeros(0, np.int64)

    def op():
        C0 = CsrMatrix.from_coo(e, e, np.zeros(0, np.float32), n, n,
                                device=DEV)
        return gt.mxm(C0, M, None, gt.semiring.plus_times[gt.FP32], A, A)

    faults, got = _sweep(op, [A, M], _cmp_tuples)
    assert faults >= 1
    assert got.nvals > 0


def _rmat_lu_values(scale):
    """The degree-prepped R-MAT graph's L and U with bench.py's values
    (uniform [0.5, 1.5) float32), and L's pattern as the mask."""
    n = 1 << scale
    I, J = gt.symmetrize_pattern(*gt.rmat_edges(scale, 16, seed=7), n)
    A = gt.csr_from_coo(I, J, np.ones(len(I), bool), n, n, type=gt.BOOL,
                        sum_duplicates=False, device=DEV)
    L, U = gt.tricount_prep_csr(A)
    rng = np.random.default_rng(3)
    out = []
    for X in (L, U, L):
        Ih, Jh, _ = X.extractTuples()
        V = rng.random(len(Ih)).astype(np.float32) + 0.5
        out.append(gt.csr_from_coo(Ih, Jh, V, n, n, type=gt.FP32,
                                   sum_duplicates=False, device=DEV))
    return out


def test_valdot_masked_spgemm_oom_sweep(monkeypatch):
    """``valdot_masked_spgemm`` on R-MAT 10 with the plan's lane floor
    lowered (as ``test_torch_slice.py`` does): the panels, the
    gather-dot and the ESC residual all run inside the sweep."""
    from graphblas_tpu_torch.sparse import bitdot as bd
    from graphblas_tpu_torch.sparse import valdot as vd
    monkeypatch.setattr(bd, "_MIN_LANES", 1)
    L, U, M = _rmat_lu_values(10)
    sr = gt.semiring.plus_times[gt.FP32]

    def op():
        C = vd.valdot_masked_spgemm(sr, L, U, M)
        assert C is not None and gt.last_axb_method().startswith("valdot:")
        return C

    faults, got = _sweep(op, [L, U, M], _cmp_tuples)
    assert faults >= 1
    assert got.nvals > 0


def test_hyper_spgemm_oom_sweep():
    from graphblas_tpu import sparse as jsp
    rng = np.random.default_rng(4)
    big = 1 << 50
    ids = np.unique(rng.integers(0, big, 64, dtype=np.int64))[:16]
    li, lj = np.nonzero(rng.random((16, 16)) < 0.4)
    X = rng.standard_normal(len(li)).astype(np.float32)
    A = hyper_from_coo(ids[li], ids[lj], X, big, big, type=gt.FP32,
                       device=DEV)
    op = lambda: hyper_spgemm(gt.semiring.plus_times[gt.FP32], A, A)
    faults, got = _sweep(op, [A], _cmp_tuples)
    assert faults >= 1
    Aj = jsp.hyper_from_coo(ids[li], ids[lj], X, big, big, type=gb.FP32)
    jfaults, want = _jax_sweep(
        lambda: jsp.hyper_spgemm(gb.semiring.plus_times[gb.FP32], Aj, Aj),
        _cmp_tuples)
    assert jfaults >= 1
    _cmp_tuples(got, want)


def test_ewise_and_wait_oom_sweep():
    Ad, Ap = rand_dense(10, 10, 0.5, np.float64, seed=5)
    Bd, Bp = rand_dense(10, 10, 0.5, np.float64, seed=6)
    A = gt.Matrix.from_dense(Ad, gt.FP64, pattern=Ap, device=DEV)
    B = gt.Matrix.from_dense(Bd, gt.FP64, pattern=Bp, device=DEV)

    def op():
        C = gt.eWiseAdd(gt.Matrix.new(gt.FP64, 10, 10, device=DEV), None,
                        None, gt.binary.plus[gt.FP64], A, B)
        # pending-tuple assembly path (GB_wait analogue)
        C = C.setElement(3.5, 2, 2, blocking=False)
        C = C.setElement(1.5, 2, 2, accum=gt.binary.plus[gt.FP64],
                         blocking=False)
        return C.wait()

    faults, got = _sweep(op, [A, B], _cmp_matrix)
    assert faults >= 1
    assert np.asarray(got.to_dense())[2, 2] == pytest.approx(5.0)
    Aj = gb.Matrix.from_dense(Ad, gb.FP64, pattern=Ap)
    Bj = gb.Matrix.from_dense(Bd, gb.FP64, pattern=Bp)

    def jop():
        C = gb.eWiseAdd(gb.Matrix.new(gb.FP64, 10, 10), None, None,
                        gb.binary.plus[gb.FP64], Aj, Bj)
        C = C.setElement(3.5, 2, 2, blocking=False)
        C = C.setElement(1.5, 2, 2, accum=gb.binary.plus[gb.FP64],
                         blocking=False)
        return C.wait()

    jfaults, want = _jax_sweep(jop, _cmp_matrix)
    assert jfaults >= 1
    _cmp_matrix(got, want)


@pytest.mark.parametrize("kind", ["csr", "hyper"])
def test_sparse_wait_oom_sweep(kind):
    """``wait`` on the sparse containers (``csr_wait`` / ``hyper_wait``
    and the merge they run): the container with the pending tuples and
    the container it came from are unchanged by a fault."""
    I, J, X = _rand_coo(8, 30, 90)
    X = X.astype(np.float64)
    if kind == "csr":
        A = CsrMatrix.from_coo(I, J, X, 30, 30, type=gt.FP64, device=DEV)
    else:
        A = hyper_from_coo(I, J, X, 1 << 45, 1 << 45, type=gt.FP64,
                           device=DEV)
    P = A.setElement(2.0, 1, 1, blocking=False)
    P = P.setElement(4.0, int(I[0]), int(J[0]),
                     accum=gt.binary.plus[gt.FP64], blocking=False)
    P = P.setElement(7.0, 29, 0, blocking=False)
    faults, got = _sweep(P.wait, [A, P], _cmp_tuples)
    assert faults >= 1
    assert got.extractElement(29, 0) == 7.0


def test_from_coo_build_oom_sweep():
    rng = np.random.default_rng(7)
    I, J = rng.integers(0, 20, 50), rng.integers(0, 20, 50)
    X = rng.standard_normal(50)
    op = lambda: gt.Matrix.from_coo(I, J, X, 20, 20, type=gt.FP64,
                                    device=DEV)
    faults, got = _sweep(op, [], _cmp_matrix)
    assert faults >= 1
    jfaults, want = _jax_sweep(
        lambda: gb.Matrix.from_coo(I, J, X, 20, 20, type=gb.FP64),
        _cmp_matrix)
    assert jfaults >= 1
    _cmp_matrix(got, want)


def test_fault_error_surface():
    """The injected failure carries GrB_OUT_OF_MEMORY and lands in the
    TLS message slot read by the C facade's GrB_error()."""
    with pytest.raises(OutOfMemory) as ei:
        with faultinject.fault_countdown(1):
            gt.Matrix.new(gt.FP32, 4, 4, device=DEV)
    assert ei.value.info == Info.OUT_OF_MEMORY
    from graphblas_tpu_torch.grb import GrB_error
    assert "OUT_OF_MEMORY" in GrB_error()
    # disarmed afterwards: same call succeeds
    M = gt.Matrix.new(gt.FP32, 4, 4, device=DEV)
    assert M.nvals() == 0


def test_countdown_is_one_shot():
    """After firing once the countdown disarms (reference semantics:
    the test harness re-arms explicitly per trial)."""
    faultinject.set_fault_countdown(1)
    with pytest.raises(OutOfMemory):
        gt.Matrix.new(gt.FP32, 2, 2, device=DEV)
    # no re-fire without re-arming
    gt.Matrix.new(gt.FP32, 2, 2, device=DEV)
    faultinject.clear_fault()


def test_countdown_validates():
    with pytest.raises(ValueError):
        faultinject.set_fault_countdown(0)


@pytest.mark.parametrize("site,op", [
    ("csr_from_coo", lambda: CsrMatrix.from_coo([0], [1], [1.0], 2, 2,
                                                device=DEV)),
    ("hyper_from_coo", lambda: hyper_from_coo([0], [1], [1.0], 2, 2,
                                              device=DEV)),
    ("Matrix.new", lambda: gt.Matrix.new(gt.FP64, 2, 2, device=DEV)),
    ("Matrix.from_dense", lambda: gt.Matrix.from_dense(np.ones((2, 2)),
                                                       device=DEV)),
    ("Matrix.from_coo", lambda: gt.Matrix.from_coo([0], [0], [1.0], 2, 2,
                                                   device=DEV)),
])
def test_site_labels(site, op):
    """Each site fires under the JAX package's label."""
    with pytest.raises(OutOfMemory, match=site):
        with faultinject.fault_countdown(1):
            op()


def _make(kind, seed, n=9):
    I, J, X = _rand_coo(seed, n, 3 * n)
    X = X.astype(np.float64)
    if kind == "bitmap":
        return gt.Matrix.from_coo(I, J, X, n, n, type=gt.FP64, device=DEV)
    if kind == "csr":
        return CsrMatrix.from_coo(I, J, X, n, n, type=gt.FP64, device=DEV)
    return hyper_from_coo(I, J, X, n, n, type=gt.FP64, device=DEV)


_PLUS = gt.binary.plus[gt.FP64]
_OPS = {
    "assign": lambda C, A, S: gt.assign(C, None, _PLUS, S, [0, 2, 4],
                                        [1, 3, 5]),
    "subassign": lambda C, A, S: gt.subassign(C, S, _PLUS, S, [1, 2, 3],
                                              [3, 4, 5]),
    "subassign_scalar": lambda C, A, S: gt.subassign_scalar(
        C, None, _PLUS, 2.5, [1, 2], [3, 4]),
    "ewise_alias": lambda C, A, S: gt.eWiseAdd(C, C, _PLUS, _PLUS, C, A),
    "apply": lambda C, A, S: gt.apply(C, None, _PLUS,
                                      gt.unary.ainv[gt.FP64], A),
    "select": lambda C, A, S: gt.select(C, None, None, gt.selectop.tril, A,
                                        0),
    "transpose": lambda C, A, S: gt.transpose(C, None, _PLUS, A),
    "extract": lambda C, A, S: gt.extract(S, None, _PLUS, A, [0, 4, 8],
                                          [1, 2, 3]),
    "setElement": lambda C, A, S: C.setElement(
        1.25, 3, 3, accum=_PLUS, blocking=False).setElement(
            2.0, 0, 0, blocking=False).wait(),
}


@pytest.mark.parametrize("kind", ["bitmap", "csr", "hyper"])
@pytest.mark.parametrize("name", sorted(_OPS))
def test_ops_leave_inputs_unchanged_oom_sweep(name, kind):
    """The sweep over operations that take their output's start from an
    input (assign, accum, aliases, pending folds), on each container:
    every fault and the final run leave C, A and the 3 x 3 operand S
    bit-identical.  Each result then takes a pending tuple and a wait,
    so a fault can fire after an operation that crosses no site of its
    own."""
    C, A, S = _make(kind, 21), _make(kind, 22), _make(kind, 23, n=3)
    fn = _OPS[name]
    faults, got = _sweep(lambda: fn(C, A, S).setElement(
        0.5, 2, 2, blocking=False).wait(), [C, A, S], _cmp_tuples_any)
    assert faults >= 1


def _cmp_tuples_any(a, b):
    for x, y in zip(a.extractTuples(), b.extractTuples()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
