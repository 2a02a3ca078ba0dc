"""PyTorch port: the distributed layer's collective census
(``graphblas_tpu_torch.parallel.introspect``), the counterpart of
``test_introspect.py``.  The JAX package reads the collectives out of
each compiled SPMD program's HLO; the port counts them as they run (no
HLO, so ``hlo_collectives`` has no counterpart: the first test checks
the census's own bookkeeping in its place).  The ring SpGEMM's census
is checked on a 4-rank gloo world: one ``ppermute`` per array of the B
slab at each of the d - 1 rotations, carrying the slab's bytes, and the
two gathers of the output.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import parallel as jpar
from graphblas_tpu.sparse import CsrMatrix

from graphblas_tpu_torch.parallel import introspect, run_world
from graphblas_tpu_torch.parallel.dist_spgemm import _balanced_boundaries
from graphblas_tpu_torch.parallel.mesh import pad_to_multiple
from graphblas_tpu_torch.parallel.parity import run_cases

D = 4


def _graph(n=256, seed=0):
    rng = np.random.default_rng(seed)
    I = np.repeat(np.arange(n), 6)
    J = rng.integers(0, n, len(I))
    keep = I != J
    I, J = I[keep], J[keep]
    lin = np.unique(np.concatenate([I * n + J, J * n + I]))
    I, J = lin // n, lin % n
    return (I, J, np.ones(len(I), bool), n, n, "BOOL")


@pytest.fixture(scope="module")
def port():
    return run_world(run_cases, D, "gloo", "cpu",
                     [("census", "census", dict(a=_graph()))], "cpu")


def test_census_bookkeeping():
    """Every collective noted inside a call is counted under that call
    and every call around it; a new call of a name replaces the last."""
    import torch
    x = torch.zeros(10, dtype=torch.float32)
    with introspect.record("outer", x):
        with introspect.record("inner"):
            introspect.note("ppermute", 512, False)
            introspect.note("ppermute", 256, True)
        introspect.note("all_gather", 40, False)
    inner = introspect.program_stats("inner")["collectives"]
    outer = introspect.program_stats("outer")
    assert inner == {"ppermute": {"calls": 2, "bytes": 768,
                                  "staged_calls": 1, "staged_bytes": 256}}
    assert outer["collectives"]["ppermute"]["calls"] == 2
    assert outer["collectives"]["all_gather"] == {
        "calls": 1, "bytes": 40, "staged_calls": 0, "staged_bytes": 0}
    assert outer["device_memory"] == {"shard_bytes": 40}
    with introspect.record("inner"):
        pass
    assert introspect.program_stats("inner")["collectives"] == {}
    introspect.enable(False)
    try:
        assert introspect.program_stats("outer") is None
    finally:
        introspect.enable(True)


def test_program_stats_after_dist_ops(port):
    I, J, X, n, _, _ = _graph()
    A = CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                           sum_duplicates=False)
    res = port["census"]
    assert not (isinstance(res, dict) and "error" in res), res
    assert res["ntri"] == jpar.dist_tricount_csr(A, jpar.make_mesh(D))

    # the ring: L's slabs, cut at equal flop weight, rotate d - 1 times
    lo = I > J
    Li, Lj = I[lo], J[lo]
    degB = np.bincount(Li, minlength=n)
    bnd = _balanced_boundaries(degB * np.bincount(Lj, minlength=n), D,
                               pad_to_multiple(n, D))
    blk = int((bnd[1:] - bnd[:-1]).max())
    slab = np.minimum(np.searchsorted(bnd[1:], Li, side="right"), D - 1)
    nzpad = pad_to_multiple(max(int(np.bincount(slab).max()), 8), 128)
    slab_bytes = 4 * (blk + 1) + 4 * nzpad + 1 * nzpad
    ring = res["ring"]["collectives"]
    assert ring["ppermute"]["calls"] == 3 * (D - 1)
    assert ring["ppermute"]["bytes"] == (D - 1) * slab_bytes
    assert ring["ppermute"]["staged_calls"] == 0
    # the output: values and presence of each rank's mask slab
    mpad = pad_to_multiple(int(np.bincount(Li // (n // D)).max()), 128)
    assert ring["all_gather"] == {"calls": 2, "bytes": 2 * 4 * mpad,
                                  "staged_calls": 0, "staged_bytes": 0}
    assert res["ring"]["device_memory"]["shard_bytes"] > 0

    # the SpMV records one all_gather of its rows
    mxv = res["mxv"]
    assert mxv["collectives"] == {"all_gather": {
        "calls": 1, "bytes": 4 * (n // D), "staged_calls": 0,
        "staged_bytes": 0}}
    assert mxv["device_memory"]["shard_bytes"] > 0
    deg = np.bincount(I, minlength=n).astype(np.float32)
    np.testing.assert_allclose(res["y"], deg)
    assert res["none"] is None
