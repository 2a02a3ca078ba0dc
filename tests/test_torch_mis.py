"""PyTorch port: ``models.mis``, Luby's MIS written with the GraphBLAS
API as the reference's ``mis.c`` writes it, runs each pass on A's
device and equals the benchmark's plain reference
(``gbbench/reference/mis.py``, which imports nothing of the port) vertex
for vertex and pass for pass: on GAP's Kronecker graph at the
``gap-kron-18-mis`` configuration's test size from seeded streams, on a
graph with isolated vertices, and on one with none (the first pass's
candidates hold every vertex, so its products take the dense-x engine).
A call reads back only its counts, and the bitmap ``eWiseAdd``,
``eWiseMult`` and ``apply`` it runs read nothing."""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from gbbench import harness
from gbbench.graphs import kron
from gbbench.reference import mis as ref
from graphblas_tpu_torch.utils import counters

DEV = "cpu"


def as_csr(g) -> gt.CsrMatrix:
    I, J = g["I"].numpy(), g["J"].numpy()
    return gt.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), g["n"],
                                 g["n"], type=gt.BOOL, sum_duplicates=False,
                                 device=DEV)


def members(v) -> torch.Tensor:
    v = v.wait()
    return v.pattern & v.values.to(torch.bool)


def graph_of(edges, n):
    I = torch.tensor([a for a, b in edges] + [b for a, b in edges])
    J = torch.tensor([b for a, b in edges] + [a for a, b in edges])
    return {"n": n, "I": I, "J": J, "X": None, "duplicates": False}


@pytest.fixture(scope="module")
def kron18_small():
    cfg = harness.load_json("configs", "gap-kron-18-mis")
    cfg = dict(cfg, **cfg["test_sizes"])
    g = kron.make(cfg, 2**31 + 7, DEV)
    return g, as_csr(g)


def run_counted(A, seed):
    counters.reset()
    counters.trace_spans(True)
    try:
        iset = gt.models.mis(A, seed=seed)
    finally:
        counters.trace_spans(False)
    return iset, counters.stats()


@pytest.mark.parametrize("seed", [1, 42, 2**31 - 1, 3_000_000_019])
def test_mis_on_kron_equals_reference(kron18_small, seed):
    g, A = kron18_small
    iset, st = run_counted(A, seed)
    want, passes = ref.luby(g, seed)
    got = members(iset)
    assert torch.equal(got, want)
    assert ref.independence_gap(g, got) == 0
    assert ref.maximal_gap(g, got) == 0
    assert gt.models.mis_check(A, iset)
    c = st["counts"]
    assert c["mis.passes"] == passes >= 2
    k = int((torch.bincount(g["I"], minlength=g["n"]) > 0).sum())
    assert c["mis.draws"] == passes * k
    # one read a call (the draws a pass and the candidates, 16 bytes),
    # then one a pass and one more after each pass's second product,
    # which the last pass skips where its members took every candidate
    spans = st["spans"]
    products = spans["gb.engines.spmv"]["count"]
    assert passes - 1 <= products - passes <= passes
    assert c["reads"] == 1 + products in (2 * passes, 2 * passes + 1)
    assert c["d2h_bytes"] == 16 and "h2d_bytes" not in c
    assert spans["gb.entry.mis"]["count"] == 1
    assert spans["gb.read.mis_nvals"]["count"] == c["reads"]
    assert spans["gb.engines.mis_score"]["count"] == passes
    assert not any(s.startswith("gb.read.") and s != "gb.read.mis_nvals"
                   for s in spans)
    # per pass the scores' apply, two eWiseAdd and an apply, an apply
    # after each second product, and one at the end
    assert spans["gb.engines.ewise"]["count"] == 3 * passes + products + 1


def test_mis_with_isolated_vertices_equals_reference():
    """Vertices 5, 6 and 9 have no edge: members from the start."""
    g = graph_of([(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (7, 8), (8, 10),
                  (10, 11), (11, 7)], 12)
    A = as_csr(g)
    for seed in (1, 2, 3):
        iset, st = run_counted(A, seed)
        want, passes = ref.luby(g, seed)
        got = members(iset)
        assert torch.equal(got, want)
        assert got[[5, 6, 9]].all()
        assert st["counts"]["mis.passes"] == passes


def test_mis_with_every_vertex_a_candidate():
    """No isolated vertex: the first pass's ``prob`` and ``new_members``
    hold every entry, which ``mis`` records without a read, and the
    products take the dense-x engine there."""
    rng = np.random.default_rng(5)
    n = 40
    edges = {(i, (i + 1) % n) for i in range(n)}
    edges |= {tuple(sorted(rng.choice(n, 2, replace=False).tolist()))
              for _ in range(30)}
    g = graph_of(sorted(edges), n)
    A = as_csr(g)
    for seed in (4, 2**40 + 3):
        iset, st = run_counted(A, seed)
        want, passes = ref.luby(g, seed)
        assert torch.equal(members(iset), want)
        assert st["counts"]["reads"] in (2 * passes, 2 * passes + 1)
        assert st["axb_methods"]["spmv:dense_x"] >= 1


def test_learn_full_spares_the_read():
    v = gt.Vector.from_dense(np.arange(6.0), gt.FP64,
                             pattern=np.array([1, 1, 0, 1, 1, 1], bool),
                             device=DEV)
    counters.reset()
    assert v.learn_full(False) is v and v.all_present() is False
    assert counters.stats()["counts"] == {}
    v.pattern[2] = True               # an edit in place: read again
    assert v.all_present() is True
    assert counters.stats()["counts"]["reads"] == 1


@pytest.mark.parametrize("op", ["eWiseAdd", "eWiseMult", "apply"])
def test_bitmap_ewise_reads_nothing(op):
    rng = np.random.default_rng(1)
    n = 30

    def vec(p):
        return gt.Vector.from_dense(rng.random(n), gt.FP64,
                                    pattern=rng.random(n) < p, device=DEV)
    u, w = vec(0.6), vec(0.5)
    m = gt.Vector.from_dense(rng.random(n) < 0.5, gt.BOOL, device=DEV)
    C = gt.Vector.new(gt.FP64, n, device=DEV)
    counters.reset()
    counters.trace_spans(True)
    try:
        if op == "apply":
            gt.apply(C, m, None, gt.unary.ainv[gt.FP64], u)
        else:
            getattr(gt, op)(C, m, None, gt.binary.plus[gt.FP64], u, w)
    finally:
        counters.trace_spans(False)
    st = counters.stats()
    assert "reads" not in st["counts"]
    assert st["spans"]["gb.engines.ewise"]["count"] == 1
