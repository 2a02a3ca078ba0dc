"""PyTorch port, the whole first slice end to end: parity with the JAX
package on the main path's graph families at small size.

Wathen FEM graphs (banded: band-ring engine) and R-MAT power-law graphs
(bitmap popcount + sort-merge) are generated by each package's own
copy of the generators, built into containers, prepped and counted by
``tricount_auto`` / ``tricount_esc``.  Counts must be equal, and each
engine the port records must map to the JAX package's through
``jax_engine_name``."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.models.generate import wathen_coo as jax_wathen_coo
from graphblas_tpu.models.rmat import rmat_edges as jax_rmat_edges
from graphblas_tpu.models.rmat import symmetrize_pattern as jax_symmetrize
from graphblas_tpu.ops.flopcount import last_axb_method as jax_last_method
from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.sparse import tri as jtri
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse import bitdot as tbd


def _lu_both(iu, ju, n):
    lo, up = iu > ju, iu < ju
    out = []
    for sel in (lo, up):
        X = np.ones(int(sel.sum()), bool)
        out.append((gt.csr_from_coo(iu[sel], ju[sel], X, n, n, type=gt.BOOL,
                                    sum_duplicates=False, device="cpu"),
                    jsp.CsrMatrix.from_coo(iu[sel], ju[sel], X, n, n,
                                           type=gb.BOOL,
                                           sum_duplicates=False)))
    return out


def _check_engine(port_name):
    assert gt.jax_engine_name(port_name) == jax_last_method(), \
        (port_name, jax_last_method())


@pytest.mark.parametrize("nx", [8, 16])
def test_wathen_slice_matches_jax(nx):
    I, J, X, n = gt.wathen_coo(nx, nx, seed=1)
    Ij, Jj, Xj, nj = jax_wathen_coo(nx, nx, seed=1)
    assert n == nj and np.array_equal(I, Ij) and np.array_equal(J, Jj)
    assert np.array_equal(X, Xj)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    (Lt, Lj), (Ut, Uj) = _lu_both(iu[off], ju[off], n)
    got = gt.tricount_auto(Lt, Ut)
    engine = gt.last_axb_method()
    want = jtri.tricount_auto(Lj, Uj)
    assert engine == "torch:tri_band_ring"
    assert got == want
    _check_engine(engine)
    assert gt.tricount_esc(Lt, Ut) == jtri.tricount_esc(Lj, Uj) == want
    _check_engine(gt.last_axb_method())
    assert gt.tricount_window(Lt, Ut) == want


def _rmat_both(scale):
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    Ij, Jj = jax_rmat_edges(scale, 16, seed=7)
    assert np.array_equal(I, Ij) and np.array_equal(J, Jj)
    I, J = gt.symmetrize_pattern(I, J, n)
    Ij, Jj = jax_symmetrize(Ij, Jj, n)
    assert np.array_equal(I, Ij) and np.array_equal(J, Jj)
    X = np.ones(len(I), bool)
    At = gt.csr_from_coo(I, J, X, n, n, type=gt.BOOL, sum_duplicates=False,
                         device="cpu")
    Aj = jsp.CsrMatrix.from_coo(I, J, X, n, n, type=gb.BOOL,
                                sum_duplicates=False)
    return gt.tricount_prep_csr(At), jtri.tricount_prep_csr(Aj)


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_slice_matches_jax(scale):
    (Lt, Ut), (Lj, Uj) = _rmat_both(scale)
    want = jtri.tricount_esc(Lj, Uj)
    assert gt.tricount_esc(Lt, Ut) == want
    _check_engine(gt.last_axb_method())
    assert gt.tricount_auto(Lt, Ut) == jtri.tricount_auto(Lj, Uj) == want
    _check_engine(gt.last_axb_method())


@pytest.mark.parametrize("scale", [10, 12])
def test_rmat_bitdot_engine_matches_jax(monkeypatch, scale):
    # at these sizes the planner would leave everything to the
    # sort-merge; let the bitmap panels take the heavy columns
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    (Lt, Ut), (Lj, Uj) = _rmat_both(scale)
    got = gt.tricount_esc(Lt, Ut)
    engine = gt.last_axb_method()
    assert engine.startswith("bitdot:")
    assert got == jtri.tricount_esc(Lj, Uj)
    _check_engine(engine)
