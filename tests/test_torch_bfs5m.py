"""PyTorch port: ``models.bfs5m``, the reference's BFS written with the
GraphBLAS API, on a ``CsrMatrix`` equals the benchmark's plain BFS
reference (``gbbench/reference/bfs5m.py``, which imports nothing of the
port): on GAP's Kronecker graph at the ``gap-kron-18`` configuration's
test size from seeded sources, and on a directed graph with parts no
source reaches.  ``bfs6`` shares the loop and gives the same levels."""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from gbbench import harness
from gbbench.graphs import kron
from gbbench.reference import bfs5m as ref

DEV = "cpu"


def dense_levels(v) -> np.ndarray:
    v = v.wait()
    return torch.where(v.pattern, v.values, 0).to(torch.int32).numpy()


def as_csr(g) -> gt.CsrMatrix:
    I, J = g["I"].numpy(), g["J"].numpy()
    return gt.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), g["n"],
                                 g["n"], type=gt.BOOL, sum_duplicates=False,
                                 device=DEV)


@pytest.fixture(scope="module")
def kron18_small():
    cfg = harness.load_json("configs", "gap-kron-18")
    cfg = dict(cfg, **cfg["test_sizes"])
    g = kron.make(cfg, 2**31 + 7, DEV)
    return g, as_csr(g)


@pytest.mark.parametrize("pick", range(4))
def test_bfs5m_on_kron_equals_reference(kron18_small, pick):
    g, A = kron18_small
    deg = torch.bincount(g["I"], minlength=g["n"])
    rng = np.random.default_rng(pick)
    cand = np.nonzero(deg.numpy() > 0)[0]
    s = int(rng.choice(cand)) if pick else int(deg.argmax())
    lev = dense_levels(gt.models.bfs5m(A, s))
    want = ref.levels(g, s).numpy()
    assert np.array_equal(lev, want)
    assert lev[s] == 1 and lev.max() >= 3


def _directed():
    """Two components and a one-way edge: 0 -> 1 -> 2 -> 0 and 2 -> 3,
    3 <-> 4; 5 -> 3 (nothing reaches 5); 6 <-> 7 apart; 8 alone."""
    edges = [(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 3), (5, 3),
             (6, 7), (7, 6)]
    I = torch.tensor([a for a, _ in edges])
    J = torch.tensor([b for _, b in edges])
    return {"n": 9, "I": I, "J": J, "X": None, "duplicates": False}


@pytest.mark.parametrize("s,want", [
    (0, [1, 2, 3, 4, 5, 0, 0, 0, 0]),
    (3, [0, 0, 0, 1, 2, 0, 0, 0, 0]),
    (5, [0, 0, 0, 2, 3, 1, 0, 0, 0]),
    (6, [0, 0, 0, 0, 0, 0, 1, 2, 0]),
    (8, [0, 0, 0, 0, 0, 0, 0, 0, 1]),
])
def test_bfs5m_unreached_parts(s, want):
    g = _directed()
    A = as_csr(g)
    lev = dense_levels(gt.models.bfs5m(A, s))
    assert lev.tolist() == want
    assert np.array_equal(lev, ref.levels(g, s).numpy())
    assert np.array_equal(dense_levels(gt.models.bfs6(A, s)), lev)


def test_bfs5m_equals_bfs_csr(kron18_small):
    g, A = kron18_small
    for s in (0, 5, 77):
        np.testing.assert_array_equal(dense_levels(gt.models.bfs5m(A, s)),
                                      gt.bfs_csr(A, s))


def _same_bitmap(a, b):
    assert a.type is b.type
    assert torch.equal(a.pattern, b.pattern)
    assert torch.equal(a.values, b.values)


@pytest.mark.parametrize("scalar", [True, False])
@pytest.mark.parametrize("masked,replace,accum", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True), (False, False, True)])
def test_whole_container_assign_equals_listed_indices(scalar, masked,
                                                      replace, accum):
    """An assign to all of C (GrB_ALL, as bfs5m's level assign) takes no
    index lists, gather or scatter, and gives what the same assign with
    every index listed gives, for a Vector and a Matrix."""
    rng = np.random.default_rng(int(scalar) * 16 + masked * 4 + replace * 2
                                + accum)
    n, k = 50, 3
    desc = gt.Descriptor(mask_scmp=masked, replace=replace)
    op = gt.binary.plus[gt.INT32] if accum else None

    def vec(p):
        return gt.Vector.from_dense(rng.integers(1, 9, n).astype(np.int32),
                                    gt.INT32, pattern=rng.random(n) < p,
                                    device=DEV)
    w, m, u = vec(0.5), vec(0.4), vec(0.6)
    x = 7 if scalar else u
    got = gt.assign_vector(w, m if masked else None, op, x, None, desc,
                           scalar=scalar)
    want = gt.assign_vector(w, m if masked else None, op, x,
                            list(range(n)), desc, scalar=scalar)
    _same_bitmap(got, want)

    def mat(p):
        return gt.Matrix.from_dense(
            rng.integers(1, 9, (n, k)).astype(np.int32), gt.INT32,
            pattern=rng.random((n, k)) < p, device=DEV)
    C, M, A = mat(0.5), mat(0.4), mat(0.6)
    x = 5 if scalar else A
    got = gt.assign(C, M if masked else None, op, x, None, gt.ALL, desc,
                    scalar=scalar)
    want = gt.assign(C, M if masked else None, op, x, list(range(n)),
                     list(range(k)), desc, scalar=scalar)
    _same_bitmap(got, want)


@pytest.mark.parametrize("t,mon", [
    (gt.BOOL, "lor"), (gt.INT8, "plus"), (gt.UINT64, "max"),
    (gt.FP32, "min"), (gt.FP64, "plus"), (gt.FC64, "plus")],
    ids=lambda x: getattr(x, "name", x))
@pytest.mark.parametrize("full", [True, False])
def test_reduce_reads_the_scalar_and_fullness_once(t, mon, full):
    """A reduce of a Vector copies its scalar and whether every entry is
    present in one read; the next product's engine choice then reads
    nothing, until the pattern is edited in place."""
    from graphblas_tpu_torch.utils import counters
    rng = np.random.default_rng(3)
    n = 40
    if t is gt.UINT64:
        x = rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)
    elif t.is_complex:
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            t.dtype)
    else:
        x = (rng.random(n) * 50).astype(t.dtype)
    pat = np.ones(n, bool) if full else rng.random(n) < 0.5
    u = gt.Vector.from_dense(x, t, pattern=pat, device=DEV)
    m = getattr(gt.monoid, mon)[t]
    counters.reset()
    got = gt.reduce_to_scalar(None, m, u)
    st = counters.stats()["counts"]
    assert st["reads"] == 1
    assert st["d2h_bytes"] == np.dtype(t.dtype).itemsize + 1
    # the monoid's reduce read back directly, its unsigned bits as such
    ref = m.reduce(u.values, where=u.pattern).reshape(1).numpy().view(
        t.dtype)[0]
    assert type(got) is type(ref)
    assert got.tobytes() == ref.tobytes()
    counters.reset()
    assert u.all_present() is full
    assert counters.stats()["counts"] == {}
    u.pattern[0] = False
    assert u.all_present() is False
    assert counters.stats()["counts"]["reads"] == 1
    counters.reset()
