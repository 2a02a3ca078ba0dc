"""The plain references on small graphs with known answers, and their
controls, which the comparison must fail."""

import itertools
from collections import deque

import numpy as np
import pytest
import torch

from gbbench.graphs import kron, wathen
from gbbench.reference import bfs_csr as rbfs
from gbbench.reference import mxm as rmxm
from gbbench.reference import tricount_auto as rtc

KRON = {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "generator_seed": 27491095}


def both_ways(edges, n):
    I = [a for a, b in edges] + [b for a, b in edges]
    J = [b for a, b in edges] + [a for a, b in edges]
    return {"n": n, "I": torch.tensor(I), "J": torch.tensor(J), "X": None,
            "duplicates": False}


def dense_triangles(g) -> int:
    n = g["n"]
    A = np.zeros((n, n), np.int64)
    A[g["I"].numpy(), g["J"].numpy()] = 1
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0)
    return int(np.trace(A @ A @ A) // 6)


@pytest.mark.parametrize("edges,n,want", [
    (list(itertools.combinations(range(5), 2)), 5, 10),   # K5
    (list(itertools.combinations(range(4), 2)), 4, 4),    # K4
    ([(0, 1), (1, 2), (2, 3), (3, 0)], 4, 0),              # a 4-cycle
    ([(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 2)], 6, 2),
])
def test_triangles_known(edges, n, want):
    assert rtc.expected(both_ways(edges, n))[0] == want


def test_triangles_duplicates_and_diagonal_ignored():
    g = both_ways([(0, 1), (1, 2), (2, 0), (0, 1), (1, 1)], 3)
    assert rtc.expected(g) == (1, {"n": 3, "m": 3})


@pytest.mark.parametrize("graph", ["kron", "wathen"])
def test_triangles_match_a_dense_count(graph):
    g = (kron.make(dict(KRON, scale=8), 4, "cpu") if graph == "kron"
         else wathen.make({"nx": 5, "ny": 4}, 4, "cpu"))
    got, info = rtc.expected(g)
    assert got == dense_triangles(g)
    pairs = {(min(a, b), max(a, b)) for a, b in
             zip(g["I"].tolist(), g["J"].tolist()) if a != b}
    assert info == {"n": g["n"], "m": len(pairs)}


def test_triangles_small_blocks_agree():
    g = kron.make(KRON, 5, "cpu")
    src, dst, key, ptr, n, _ = rtc.count(g)
    whole = sum(int(h.sum()) for h in rtc.wedge_hits(src, dst, key, ptr, n))
    small = sum(int(h.sum()) for h in rtc.wedge_hits(src, dst, key, ptr, n,
                                                     block=97))
    assert whole == small == rtc.expected(g)[0]


def test_triangle_control_fails():
    """bfloat16's running total is off on a count of 77 thousand; float32
    is still exact there (its mantissa holds 2^24)."""
    g = kron.make(KRON, 5, "cpu")
    nums = rtc.control_numbers(g)
    assert nums["count_gap"] > rtc.LIMITS["count_gap"]
    assert nums["count_gap_float32"] == 0


def random_coo(rng, n, nnz, lo=0.5, hi=1.5):
    key = np.unique(rng.integers(0, n * n, nnz))
    r, c = key // n, key % n
    v = rng.uniform(lo, hi, len(key)).astype(np.float32)
    return (torch.from_numpy(r), torch.from_numpy(c), torch.from_numpy(v))


def dense(coo, n, dtype=np.float64):
    D = np.zeros((n, n), dtype)
    D[coo[0].numpy(), coo[1].numpy()] = coo[2].numpy()
    return D


def test_masked_product_matches_dense():
    rng = np.random.default_rng(5)
    n = 40
    A, B, M = (random_coo(rng, n, 300) for _ in range(3))
    Mv = M[2].clone()
    Mv[::7] = 0                      # a mask entry that is present but false
    M = (M[0], M[1], Mv)
    got = rmxm.product(A, B, M, n)
    P = dense(A, n) @ dense(B, n)
    S = np.abs(dense(A, n)) @ np.abs(dense(B, n))
    Adn, Bdn = dense(A, n) != 0, dense(B, n) != 0
    terms = Adn.astype(int) @ Bdn.astype(int)
    mask = dense(M, n) != 0
    want = np.flatnonzero((mask & (terms > 0)).reshape(-1))
    assert np.array_equal(got["key"].numpy(), want)
    np.testing.assert_allclose(got["value"].numpy(), P.reshape(-1)[want],
                               rtol=1e-12)
    np.testing.assert_allclose(got["magnitude"].numpy(),
                               S.reshape(-1)[want], rtol=1e-12)


def test_masked_product_compare():
    want = {"key": torch.tensor([1, 5, 7]),
            "value": torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64),
            "magnitude": torch.tensor([1.0, 2.0, 4.0],
                                      dtype=torch.float64)}
    n = 3
    same = rmxm.compare(torch.tensor([0, 1, 2]), torch.tensor([1, 2, 1]),
                        torch.tensor([1.0, 2.0, 4.0]), want, n)
    assert same == (0, 0.0)
    off = rmxm.compare(torch.tensor([0, 2]), torch.tensor([1, 1]),
                       torch.tensor([1.5, 4.0]), want, n)
    assert off == (1, 0.5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.0e-3])
    y = rmxm.tf32(x)
    assert y[0] == 1.0 and y[2] == x[2]
    assert y[1] in (1.0, 1.0 + 2.0 ** -10)
    assert abs(float(y[3]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


def test_product_control_fails():
    g = kron.make(KRON, 6, "cpu")
    from gbbench.entries import mxm as emxm
    inputs = emxm.make_inputs(g, {}, {"values": [0.5, 1.5]}, 6, "cpu")
    nums = rmxm.control_numbers(inputs)
    assert nums["pattern_gap"] == 0
    assert nums["value_gap"] > 3 * rmxm.LIMITS["value_gap"]


def python_bfs(n, edges, s):
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
    lev = [0] * n
    lev[s] = 1
    q = deque([s])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if lev[v] == 0:
                lev[v] = lev[u] + 1
                q.append(v)
    return lev


def test_bfs_path_and_unreached():
    g = both_ways([(0, 1), (1, 2), (2, 3)], 6)
    assert rbfs.levels(g, 1).tolist() == [2, 1, 2, 3, 0, 0]


def test_bfs_follows_rows_to_columns():
    g = {"n": 3, "I": torch.tensor([0, 1]), "J": torch.tensor([1, 2])}
    assert rbfs.levels(g, 0).tolist() == [1, 2, 3]
    assert rbfs.levels(g, 2).tolist() == [0, 0, 1]


def test_bfs_matches_python():
    g = kron.make(dict(KRON, scale=9), 8, "cpu")
    edges = list(zip(g["I"].tolist(), g["J"].tolist()))
    for s in (0, 17, 200):
        assert rbfs.levels(g, s).tolist() == python_bfs(g["n"], edges, s)


def test_bfs_control_fails():
    """A vertex reached from 200 frontier vertices at once: an int8 count
    of them wraps negative, and the control misses it."""
    n = 203
    edges = ([(0, k) for k in range(1, 201)]
             + [(k, 201) for k in range(1, 201)] + [(201, 202)])
    g = dict(both_ways(edges, n), sources=[0])
    assert rbfs.levels(g, 0)[201] == 3
    assert rbfs.control_numbers(g)["level_gap"] > 0
