"""PyTorch port, padded-CSR container: parity with the JAX package.

The same COO tuples, made with numpy from a seed, go through
``graphblas_tpu.sparse.csr_from_coo`` and the port's counterpart on the
CPU; every array, count and host pattern must be equal (exactly: all are
integers or the same stored values)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu import sparse as jsp
from graphblas_tpu.core.types import type_of_dtype as jax_type_of_dtype
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import convert


def _coo(seed, nrows, ncols, ntuples, dtype, dups):
    rng = np.random.default_rng(seed)
    I = rng.integers(0, nrows, ntuples)
    J = rng.integers(0, ncols, ntuples)
    if dups:
        I = np.concatenate([I, I[:ntuples // 3]])
        J = np.concatenate([J, J[:ntuples // 3]])
    else:
        lin = np.unique(I * ncols + J)
        rng.shuffle(lin)
        I, J = lin // ncols, lin % ncols
    if dtype == np.bool_:
        X = np.ones(len(I), bool)
    else:
        X = (rng.integers(1, 100, len(I))).astype(dtype)
    return I, J, X


def _assert_same(At, Aj):
    assert At.nvals == Aj.nvals and At.shape == Aj.shape
    assert At.type.name == Aj.type.name
    assert np.array_equal(At.indptr.numpy(), np.asarray(Aj.indptr))
    assert np.array_equal(At.indices.numpy(), np.asarray(Aj.indices))
    assert np.array_equal(At.rowids.numpy(), np.asarray(Aj.rowids))
    vj = np.asarray(Aj.values)
    assert np.array_equal(At.values.numpy(), At.type.to_storage(vj))
    for ht, hj in zip(At._options["host_pattern"],
                      Aj._options["host_pattern"]):
        assert np.array_equal(ht, np.asarray(hj))


CASES = [(np.bool_, False), (np.float64, True), (np.float64, False),
         (np.int32, True), (np.uint32, True), (np.uint8, False)]


@pytest.mark.parametrize("dtype,dups", CASES)
def test_csr_from_coo_matches_jax(dtype, dups):
    I, J, X = _coo(1, 37, 53, 400, dtype, dups)
    t = gt.type_of_dtype(dtype)
    At = gt.csr_from_coo(I, J, X, 37, 53, type=t, device="cpu")
    Aj = jsp.csr_from_coo(I, J, X, 37, 53,
                          type=jax_type_of_dtype(dtype))
    _assert_same(At, Aj)
    It, Jt, Xt = At.extractTuples()
    Ij, Jj, Xj = Aj.extractTuples()
    assert np.array_equal(It, Ij) and np.array_equal(Jt, Jj)
    assert np.array_equal(Xt, np.asarray(Xj)) and Xt.dtype == Xj.dtype


@pytest.mark.parametrize("sum_duplicates", [True, False])
def test_csr_from_coo_no_dedup_and_capacity(sum_duplicates):
    I, J, X = _coo(2, 20, 20, 150, np.float64, True)
    At = gt.csr_from_coo(I, J, X, 20, 20, nzmax=512,
                         sum_duplicates=sum_duplicates, device="cpu")
    Aj = jsp.csr_from_coo(I, J, X, 20, 20, nzmax=512,
                          sum_duplicates=sum_duplicates)
    assert At.nzmax == Aj.nzmax == 512
    _assert_same(At, Aj)


def test_transpose_matches_jax():
    I, J, X = _coo(3, 30, 45, 200, np.int32, False)
    At = gt.csr_from_coo(I, J, X, 30, 45, device="cpu").T()
    Aj = jsp.csr_from_coo(I, J, X, 30, 45).T()
    assert At.shape == (45, 30)
    _assert_same(At, Aj)


@pytest.mark.parametrize("I,J", [([0, 5], [1, 2]), ([-1, 0], [0, 0]),
                                 ([0, 1], [0, 9])])
def test_index_out_of_bounds(I, J):
    X = np.ones(2, bool)
    with pytest.raises(gt.IndexOutOfBounds):
        gt.csr_from_coo(I, J, X, 4, 9, device="cpu")
    with pytest.raises(gb.IndexOutOfBounds):
        jsp.csr_from_coo(I, J, X, 4, 9)


def test_empty_matrix():
    e = np.zeros(0, np.int64)
    At = gt.csr_from_coo(e, e, np.zeros(0, bool), 5, 7, device="cpu")
    Aj = jsp.csr_from_coo(e, e, np.zeros(0, bool), 5, 7)
    assert At.nvals == 0 and At.nzmax == Aj.nzmax
    _assert_same(At, Aj)


def test_convert_roundtrip_csr():
    I, J, X = _coo(4, 64, 64, 500, np.uint32, True)
    Aj = jsp.csr_from_coo(I, J, X, 64, 64)
    At = convert.from_jax(Aj, device="cpu")
    _assert_same(At, Aj)
    assert At.type is gt.UINT32 and At.values.dtype == gt.UINT32.storage


def test_default_device_follows_cuda():
    A = gt.csr_from_coo([0], [1], np.ones(1, bool), 2, 2)
    assert A.device == gt.default_device()
    assert gt.default_device().type == (
        "cuda" if torch.cuda.is_available() else "cpu")


def test_port_imports_no_jax():
    code = ("import sys, graphblas_tpu_torch, graphblas_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'graphblas_tpu.')) "
            "or m == 'graphblas_tpu']; "
            "from graphblas_tpu_torch import _build; "
            "assert _build.build_info is None and _build._LIB is None; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
