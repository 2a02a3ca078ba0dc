"""PyTorch port: the sharded-CSR SpMV over any semiring and the ring
masked SpGEMM (``graphblas_tpu_torch.parallel``) against the JAX
package's, case for case with ``test_dist_csr.py``, and against the
single-device engines of both.

The port's side runs in one gloo world of 4 CPU ranks started once for
the module (``run_world`` with ``parallel/parity.py``'s rank side); the
JAX side on its 8-device CPU mesh.  Inputs are numpy arrays from fixed
seeds.  Patterns, integers and booleans must be equal; float values
agree within rtol 1e-5, atol 1e-6 (float32) and 1e-12 (float64).

The trap cases hold the port's folds to its rules (LOR/LAND over
INT8/UINT8 as the op, NaN terms dropped under MIN/MAX, UINT64 at or
above 2^63 in unsigned order, complex SpMV) against its single-device
engines, and pin the JAX package's distributed values where they
differ (ROADMAP.md, "Known in the reference").
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu.parallel as jpar
import graphblas_tpu.sparse as jsp
from graphblas_tpu.core.semirings import semiring as jsemiring

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.parallel import run_world
from graphblas_tpu_torch.parallel.parity import run_cases

TOL = {np.dtype(np.float32): dict(rtol=1e-5, atol=1e-6),
       np.dtype(np.float64): dict(rtol=1e-12, atol=1e-12)}


def rand_coo(seed, r, c, nnz, t, valrange=(1, 9)):
    """Random tuples (duplicates summed by from_coo), as test_dist_csr's
    ``rand_csr``."""
    rng = np.random.default_rng(seed)
    I = rng.integers(0, r, nnz)
    J = rng.integers(0, c, nnz)
    dt = np.dtype(getattr(gb, t).dtype)
    if dt == np.bool_:
        X = np.ones(nnz, bool)
    elif np.issubdtype(dt, np.integer):
        X = rng.integers(*valrange, nnz).astype(dt)
    else:
        X = rng.random(nnz).astype(dt) + 0.5
    return (I, J, X, r, c, t)


def jcsr(a):
    I, J, X, r, c, t = a
    return jsp.CsrMatrix.from_coo(I, J, X, r, c, type=getattr(gb, t))


def pcsr(a):
    I, J, X, r, c, t = a
    return gt.CsrMatrix.from_coo(I, J, X, r, c, type=getattr(gt, t),
                                 device="cpu")


MXV_CASES = [
    ("plus", "times", "FP32"),
    ("min", "plus", "FP64"),
    ("max", "second", "INT64"),
    ("lor", "land", "BOOL"),
    ("plus", "pair", "INT32"),
]

SPGEMM_CASES = [
    ("plus", "times", "FP32"),
    ("plus", "pair", "INT32"),
    ("min", "plus", "FP64"),
    ("max", "first", "INT32"),
    ("lor", "land", "BOOL"),
    ("times", "times", "FP64"),
]


def _mxv_inputs(k, t):
    n = 96
    a = rand_coo(100 + k, n, n, 400, t)
    rng = np.random.default_rng(200 + k)
    dt = np.dtype(getattr(gb, t).dtype)
    x = (rng.integers(0, 2, n).astype(bool) if dt == np.bool_
         else rng.integers(1, 5, n).astype(dt))
    return a, x


def _spgemm_inputs(k, t):
    m, kk, n = 48, 56, 40
    return (rand_coo(300 + k, m, kk, 300, t), rand_coo(400 + k, kk, n, 300, t),
            rand_coo(500 + k, m, n, 250, t))


def _tricount_input():
    rng = np.random.default_rng(42)
    n = 200
    i = rng.integers(0, n, 1200)
    j = rng.integers(0, n, 1200)
    keep = i != j
    i, j = i[keep], j[keep]
    return (np.concatenate([i, j]), np.concatenate([j, i]),
            np.ones(2 * len(i), np.uint32), n, n, "UINT32")


def _lxor_input():
    rng = np.random.default_rng(43)
    n = 24
    Ap = np.zeros((n, n), bool)
    Ap[rng.integers(0, n, 60), rng.integers(0, n, 60)] = True
    I, J = np.nonzero(Ap)
    return (I, J, np.ones(len(I), bool), n, n, "BOOL")


# -- trap inputs: n = 8, rows 0-1 on rank 0 and 4-5 on rank 2 ---------------

def _tuples(t, entries, n=8):
    dt = np.dtype(getattr(gb, t).dtype)
    I = np.array([i for i, _ in entries], np.int64)
    J = np.array([j for _, j in entries], np.int64)
    X = np.array(list(entries.values()), dt)
    return (I, J, X, n, n, t)


#: y = A x with x all ones: row i of A folds; rows 0-2 carry the traps
MXV_TRAPS = {
    "lor_int8": (("lor_first", "INT8"), _tuples(
        "INT8", {(0, 0): -1, (0, 4): -2, (1, 1): 5, (1, 5): 0,
                 (2, 2): -1})),
    "land_uint8": (("land_first", "UINT8"), _tuples(
        "UINT8", {(0, 0): 2, (0, 4): 3, (1, 1): 5, (1, 5): 0,
                  (2, 2): 255})),
    "nan_min": (("min_plus", "FP64"), _tuples(
        "FP64", {(0, 0): np.nan, (0, 4): 5.0, (1, 1): np.nan,
                 (2, 2): -3.0, (2, 6): np.nan})),
    "nan_max": (("max_plus", "FP64"), _tuples(
        "FP64", {(0, 0): np.nan, (0, 4): 5.0, (1, 1): np.nan,
                 (2, 2): -3.0, (2, 6): np.nan})),
    "uint64_max": (("max_first", "UINT64"), _tuples(
        "UINT64", {(0, 0): 2 ** 63 + 5, (0, 4): 7, (1, 1): 2 ** 64 - 1,
                   (1, 5): 2 ** 63, (2, 2): 3, (2, 6): 2 ** 63 - 1})),
    "fc64_plus": (("plus_times", "FC64"), _tuples(
        "FC64", {(0, 0): 1 + 2j, (0, 4): 1 - 2j, (1, 1): 0.5j,
                 (1, 5): 3 + 0j, (2, 2): -1j})),
    "fc32_max": (("max_first", "FC32"), _tuples(
        "FC32", {(0, 0): 1 + 2j, (0, 4): 1 - 2j, (1, 1): np.nan + 1j,
                 (1, 5): 3 + 0j, (2, 2): -1j, (2, 3): -1 + 5j})),
}

#: C<M> = A B with M = all of rows 0-3; A's rows 0-2 reach B's rows on
#: different B slabs (B(k, 0) for k = 0 and 6), so the fold crosses
#: ring steps
SPGEMM_TRAPS = {
    "lor_int8": (("lor_second", "INT8"), {(0, 0): 1, (0, 6): 1},
                 {(0, 0): -1, (6, 0): -2}),
    "land_uint8": (("land_second", "UINT8"), {(0, 0): 1, (0, 6): 1},
                   {(0, 0): 2, (6, 0): 3}),
    "land_int8": (("land_second", "INT8"), {(0, 0): 1, (0, 6): 1},
                  {(0, 0): -1, (6, 0): 3}),
    "nan_min": (("min_second", "FP64"), {(0, 0): 1, (0, 6): 1},
                {(0, 0): np.nan, (6, 0): 5.0}),
    "nan_max": (("max_second", "FP64"), {(0, 0): 1, (0, 6): 1},
                {(0, 0): np.nan, (6, 0): 5.0}),
    "uint64_max": (("max_second", "UINT64"), {(0, 0): 1, (0, 6): 1},
                   {(0, 0): 2 ** 63 + 5, (6, 0): 7}),
}


def _spgemm_trap(name):
    (fam, t), a, b = SPGEMM_TRAPS[name]
    M = _tuples("BOOL", {(i, j): True for i in range(4) for j in range(8)})
    return (fam, t), _tuples(t, a), _tuples(t, b), M


def _cases():
    c = []
    for k, (addn, multn, t) in enumerate(MXV_CASES):
        a, x = _mxv_inputs(k, t)
        c.append((f"mxv_{addn}_{multn}_{t}", "csr_mxv",
                  dict(a=a, x=x, sr=(f"{addn}_{multn}", t))))
    for k, (addn, multn, t) in enumerate(SPGEMM_CASES):
        a, b, m = _spgemm_inputs(k, t)
        c.append((f"spgemm_{addn}_{multn}_{t}", "masked_spgemm",
                  dict(sr=(f"{addn}_{multn}", t), a=a, b=b, m=m)))
    c.append(("tricount", "tricount_csr", dict(a=_tricount_input())))
    L = _lxor_input()
    c.append(("lxor", "masked_spgemm",
              dict(sr=("lxor_land", "BOOL"), a=L, b=L, m=L)))
    for name, (sr, a) in MXV_TRAPS.items():
        t = sr[1]
        x = np.ones(8, np.dtype(getattr(gb, t).dtype))
        c.append((f"trap_mxv_{name}", "csr_mxv", dict(a=a, x=x, sr=sr)))
    for name in SPGEMM_TRAPS:
        sr, a, b, m = _spgemm_trap(name)
        c.append((f"trap_spgemm_{name}", "masked_spgemm",
                  dict(sr=sr, a=a, b=b, m=m)))
    return c


@pytest.fixture(scope="module")
def port():
    return run_world(run_cases, 4, "gloo", "cpu", _cases(), "cpu")


@pytest.fixture(scope="module")
def mesh():
    return jpar.make_mesh()


def _ok(res):
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, **TOL[np.dtype(
            want.real.dtype)])
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("k,addn,multn,t",
                         [(k, *c) for k, c in enumerate(MXV_CASES)],
                         ids=[f"{a}_{m}_{t}" for a, m, t in MXV_CASES])
def test_dist_csr_mxv_general(port, mesh, k, addn, multn, t):
    a, x = _mxv_inputs(k, t)
    sr = jsemiring[f"{addn}_{multn}"][getattr(gb, t)]
    want, wpat = jsp.csr_mxv(sr, jcsr(a), x)
    want, wpat = np.asarray(want), np.asarray(wpat)
    got = _ok(port[f"mxv_{addn}_{multn}_{t}"])
    jd = np.asarray(jpar.dist_csr_mxv(jpar.dist_csr_from_matrix(
        jcsr(a), mesh), x, sr))
    # the distributed y is dense: the identity where no contribution
    _close(got[wpat], want[wpat])
    _close(got, jd)
    ident = np.asarray(sr.add.identity).astype(got.dtype)
    assert np.all(got[~wpat] == ident)


@pytest.mark.parametrize("k,addn,multn,t",
                         [(k, *c) for k, c in enumerate(SPGEMM_CASES)],
                         ids=[f"{a}_{m}_{t}" for a, m, t in SPGEMM_CASES])
def test_dist_masked_spgemm_vs_esc(port, mesh, k, addn, multn, t):
    a, b, m = _spgemm_inputs(k, t)
    sr = jsemiring[f"{addn}_{multn}"][getattr(gb, t)]
    A, B, M = jcsr(a), jcsr(b), jcsr(m)
    gI, gJ, gX = _ok(port[f"spgemm_{addn}_{multn}_{t}"])
    for ref in (jsp.csr_spgemm(sr, A, B, mask=M),
                jpar.dist_masked_spgemm(sr, A, B, M, mesh)):
        wI, wJ, wX = ref.extractTuples()
        assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
        _close(gX, wX)


def test_dist_tricount_csr(port, mesh):
    A = jcsr(_tricount_input())
    want = jsp.tricount_sparse(A)
    assert _ok(port["tricount"]) == want == jpar.dist_tricount_csr(A, mesh)


def test_dist_masked_spgemm_generic_monoid(port, mesh):
    """LXOR has no scatter fold: the sort-and-scan fold."""
    A = jcsr(_lxor_input())
    sr = jsemiring.lxor_land[gb.BOOL]
    gI, gJ, gX = _ok(port["lxor"])
    for ref in (jsp.csr_spgemm(sr, A, A, mask=A),
                jpar.dist_masked_spgemm(sr, A, A, A, mesh)):
        wI, wJ, wX = ref.extractTuples()
        assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
        assert np.array_equal(gX, np.asarray(wX))


# -- the port's fold rules, and the JAX package's values pinned -------------

#: the JAX package's dist_csr_mxv on the trap inputs, rows 0-2: LOR/LAND
#: fold by max/min of the values (no identity), NaN propagates through
#: MIN/MAX; UINT64 and complex agree with the port
JAX_MXV = {
    "lor_int8": [-1, 5, -1],
    "land_uint8": [2, 0, 255],
    "nan_min": [np.nan, np.nan, np.nan],
    "nan_max": [np.nan, np.nan, np.nan],
    "uint64_max": [2 ** 63 + 5, 2 ** 64 - 1, 2 ** 63 - 1],
    "fc64_plus": [2 + 0j, 3 + 0.5j, -1j],
    "fc32_max": [1 + 2j, 3 + 0j, -1j],
}


@pytest.mark.parametrize("name", sorted(MXV_TRAPS))
def test_dist_csr_mxv_folds_follow_the_port(port, mesh, name):
    sr, a = MXV_TRAPS[name]
    T = getattr(gt, sr[1])
    s = gt.semiring[sr[0]][T]
    x = np.ones(8, np.dtype(T.dtype))
    want, wpat = gt.csr_mxv(s, pcsr(a), x)
    from graphblas_tpu_torch.core.matrix import host_values
    want, wpat = host_values(want, s.ztype), wpat.numpy()
    got = _ok(port[f"trap_mxv_{name}"])
    assert np.array_equal(got[wpat], want[wpat], equal_nan=True)
    jsr = jsemiring[sr[0]][getattr(gb, sr[1])]
    jd = np.asarray(jpar.dist_csr_mxv(jpar.dist_csr_from_matrix(
        jcsr(a), mesh), x, jsr))[:3]
    np.testing.assert_array_equal(jd, np.asarray(JAX_MXV[name],
                                                 dtype=want.dtype))


#: the JAX package's dist_masked_spgemm on the trap inputs, the value at
#: (0, 0): its scatter folds take LOR/LAND as max/min of the values from
#: the identity (0 / 1) and propagate NaN; UINT64 agrees with the port
JAX_SPGEMM = {
    "lor_int8": 0,
    "land_uint8": 1,
    "land_int8": -1,
    "nan_min": np.nan,
    "nan_max": np.nan,
    "uint64_max": 2 ** 63 + 5,
}


@pytest.mark.parametrize("name", sorted(SPGEMM_TRAPS))
def test_dist_masked_spgemm_folds_follow_the_port(port, mesh, name):
    (fam, t), a, b, m = _spgemm_trap(name)
    s = gt.semiring[fam][getattr(gt, t)]
    want = gt.csr_spgemm(s, pcsr(a), pcsr(b), mask=pcsr(m))
    wI, wJ, wX = want.extractTuples()
    gI, gJ, gX = _ok(port[f"trap_spgemm_{name}"])
    assert np.array_equal(gI, wI) and np.array_equal(gJ, wJ)
    assert np.array_equal(gX, wX, equal_nan=True)
    jsr = jsemiring[fam][getattr(gb, t)]
    jd = jpar.dist_masked_spgemm(jsr, jcsr(a), jcsr(b), jcsr(m), mesh)
    jX = np.asarray(jd.extractTuples()[2])
    np.testing.assert_array_equal(jX[:1], np.asarray([JAX_SPGEMM[name]],
                                                     dtype=wX.dtype))
