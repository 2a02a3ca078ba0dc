"""The graph generators: determinism by seed, the Kronecker recipe's
shape, the Wathen numbering."""

import itertools

import pytest
import torch

from gbbench.graphs import kron, wathen

KRON = {"scale": 9, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "generator_seed": 27491095}


def test_kron_same_seed_same_graph():
    a = kron.make(KRON, 2**31 + 7, "cpu")
    b = kron.make(KRON, 2**31 + 7, "cpu")
    assert torch.equal(a["I"], b["I"]) and torch.equal(a["J"], b["J"])


def test_kron_seed_relabels_a_fixed_structure():
    """The structure comes from the configuration's generator seed; the
    run's seed only scrambles the labels: same degree multiset, other
    labels."""
    a = kron.make(KRON, 11, "cpu")
    b = kron.make(KRON, 12, "cpu")
    assert a["I"].numel() == b["I"].numel()
    assert not torch.equal(a["I"], b["I"])
    da = torch.sort(torch.bincount(a["I"], minlength=a["n"])).values
    db = torch.sort(torch.bincount(b["I"], minlength=b["n"])).values
    assert torch.equal(da, db)
    c = kron.make(dict(KRON, generator_seed=5), 11, "cpu")
    assert c["I"].numel() != a["I"].numel()


def test_kron_is_simple_undirected_and_sorted():
    g = kron.make(KRON, 3, "cpu")
    n, I, J = g["n"], g["I"], g["J"]
    assert n == 512 and g["X"] is None and not g["duplicates"]
    key = I * n + J
    assert torch.all(key[1:] > key[:-1])          # sorted, no duplicate
    assert not torch.any(I == J)
    assert torch.equal(torch.sort(J * n + I).values, key)   # symmetric
    # the Kronecker skew: the largest degree far above the mean
    deg = torch.bincount(I, minlength=n).double()
    assert deg.max() > 8 * deg[deg > 0].mean()


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 1), (3, 4), (6, 5)])
def test_wathen_numbering(nx, ny):
    g = wathen.make({"nx": nx, "ny": ny}, 1, "cpu")
    n = g["n"]
    assert n == 3 * nx * ny + 2 * nx + 2 * ny + 1
    nn = wathen.nodes(nx, ny, "cpu").reshape(-1, 8)
    # every node belongs to an element, each element has 8 distinct nodes
    assert torch.equal(torch.unique(nn), torch.arange(n))
    assert all(len(set(e.tolist())) == 8 for e in nn)
    # the triplets are the 8 x 8 blocks of the elements' nodes
    pairs = set(zip(g["I"].tolist(), g["J"].tolist()))
    want = {(a, b) for e in nn.tolist() for a, b in
            itertools.product(e, e)}
    assert pairs == want
    assert g["I"].numel() == 64 * nx * ny and g["duplicates"]


def test_wathen_single_element_matrix():
    """One element: the assembled matrix is rho times gallery('wathen')'s
    element matrix, which is symmetric."""
    g = wathen.make({"nx": 1, "ny": 1}, 9, "cpu")
    A = torch.zeros(8, 8, dtype=torch.float64)
    A.index_put_((g["I"], g["J"]), g["X"], accumulate=True)
    E = torch.tensor(wathen.ELEMENT, dtype=torch.float64) / 45.0
    rho = A[0, 0] / E[0, 0]
    nn = wathen.nodes(1, 1, "cpu").reshape(8)
    assert torch.allclose(A[nn][:, nn], rho * E)
    assert torch.equal(E, E.T) and 0 <= rho < 100


def test_wathen_seed_draws_only_the_densities():
    a = wathen.make({"nx": 4, "ny": 3}, 1, "cpu")
    b = wathen.make({"nx": 4, "ny": 3}, 2, "cpu")
    assert torch.equal(a["I"], b["I"]) and torch.equal(a["J"], b["J"])
    assert not torch.equal(a["X"], b["X"])
    c = wathen.make({"nx": 4, "ny": 3}, 1, "cpu")
    assert torch.equal(a["X"], c["X"])
