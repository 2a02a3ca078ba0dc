"""PyTorch port: ``CsrMatrix.T`` sorts on the container's device and
gives, array for array and bit for bit, what the host resort gives (the
live tuples copied back and rebuilt by ``csr_from_coo`` with the
coordinates swapped): row pointers, indices, row ids, values (struct
fields too), counts, capacity, padding and type.  Its host pattern is
the pair ``csr_from_coo`` keeps, copied back only when a reader asks."""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.sparse.container import CsrMatrix, HostPattern
from graphblas_tpu_torch.utils import counters
from graphblas_tpu_torch.utils.tree import tree_leaves

DEV = "cpu"
POINT = gt.Type.udt("point", x=gt.FP64, y=gt.INT32)


def host_resort(A: CsrMatrix) -> CsrMatrix:
    """The transpose as a host resort of the live tuples."""
    A = A.wait()
    I, J, X = A.extractTuples()
    return gt.csr_from_coo(J, I, X, A.ncols, A.nrows, type=A.type,
                           nzmax=A.nzmax, sum_duplicates=False,
                           device=A.device)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().numpy().tobytes()


def assert_same(got: CsrMatrix, want: CsrMatrix):
    assert (got.nrows, got.ncols, got.nvals, got.nzmax) == (
        want.nrows, want.ncols, want.nvals, want.nzmax)
    assert got.type is want.type and got.device == want.device
    assert not got._pending
    for name in ("indptr", "indices", "rowids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.int32, name
        assert torch.equal(a, b), name
    ga, wa = tree_leaves(got.values), tree_leaves(want.values)
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)
    hg, hw = got._options["host_pattern"], want._options["host_pattern"]
    for a, b in zip(hg, hw):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _coo(seed, nrows, ncols, nnz, dups=False):
    rng = np.random.default_rng(seed)
    I = rng.integers(0, nrows, nnz)
    J = rng.integers(0, ncols, nnz)
    if dups:
        return np.concatenate([I, I[:nnz // 3]]), np.concatenate(
            [J, J[:nnz // 3]])
    lin = np.unique(I * ncols + J)
    rng.shuffle(lin)
    return lin // ncols, lin % ncols


def _values(seed, t, k):
    rng = np.random.default_rng(seed)
    if t is gt.BOOL:
        return rng.random(k) < 0.7
    if t is gt.INT64:
        return rng.integers(-2**62, 2**62, k)
    if t is gt.UINT64:
        return rng.integers(0, 2**64 - 1, k, dtype=np.uint64)
    if t in (gt.FP32, gt.FP64):
        x = rng.standard_normal(k).astype(t.dtype)
        x[::7] = np.nan
        x[1::11] = -0.0
        x[2::13] = np.inf
        return x
    if t in (gt.FC32, gt.FC64):
        return (rng.standard_normal(k) + 1j * rng.standard_normal(k)
                ).astype(t.dtype)
    return {"x": rng.standard_normal(k), "y": rng.integers(-50, 50, k)}


TYPES = [gt.BOOL, gt.INT64, gt.UINT64, gt.FP32, gt.FP64, gt.FC32, gt.FC64,
         POINT]


@pytest.mark.parametrize("t", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("shape,nnz", [((37, 53), 400), ((53, 37), 300),
                                       ((40, 40), 40), ((1, 9), 5)])
def test_device_transpose_equals_host_resort(t, shape, nnz):
    """Rectangular and square, sparse to a single row."""
    m, n = shape
    I, J = _coo(m * n + nnz, m, n, nnz)
    A = gt.csr_from_coo(I, J, _values(nnz, t, len(I)), m, n, type=t,
                        sum_duplicates=False, device=DEV)
    At = A.T()
    assert_same(At, host_resort(A))
    assert At.shape == (n, m)


@pytest.mark.parametrize("t", [gt.BOOL, gt.FP32, POINT],
                         ids=lambda t: t.name)
def test_empty_rows_and_columns(t):
    """Rows 0-4 and 20-29 and columns 0-3, 10 and 17 hold nothing."""
    I, J = _coo(11, 15, 14, 80)
    keep = (J != 6) & (J != 13)
    I, J = I[keep] + 5, J[keep] + 4
    A = gt.csr_from_coo(I, J, _values(11, t, len(I)), 30, 18, type=t,
                        sum_duplicates=False, device=DEV)
    At = A.T()
    assert_same(At, host_resort(A))
    deg = At.row_degrees()
    assert (deg[[0, 1, 2, 3, 10, 17]] == 0).all()
    assert torch.equal(At.indptr[-1], torch.tensor(A.nvals,
                                                   dtype=torch.int32))


@pytest.mark.parametrize("t", [gt.BOOL, gt.FP64, POINT],
                         ids=lambda t: t.name)
def test_no_entries(t):
    e = np.zeros(0, np.int64)
    A = gt.csr_from_coo(e, e, _values(0, t, 0), 5, 7, type=t, device=DEV)
    assert A.nvals == 0
    assert_same(A.T(), host_resort(A))


@pytest.mark.parametrize("t", [gt.INT64, gt.FC64, POINT],
                         ids=lambda t: t.name)
def test_padding_above_nvals(t):
    I, J = _coo(5, 20, 30, 90)
    A = gt.csr_from_coo(I, J, _values(5, t, len(I)), 20, 30, type=t,
                        nzmax=1024, sum_duplicates=False, device=DEV)
    At = A.T()
    assert At.nzmax == 1024
    assert_same(At, host_resort(A))
    assert (At.indices[At.nvals:] == 20).all()
    assert (At.rowids[At.nvals:] == 30).all()


def test_duplicates_keep_storage_order():
    """Tuples kept apart (no dup fold) stay in their stored order within
    a (column, row), as the host's stable sort keeps them."""
    I, J = _coo(6, 15, 12, 120, dups=True)
    X = np.arange(len(I), dtype=np.float64)
    A = gt.csr_from_coo(I, J, X, 15, 12, sum_duplicates=False, device=DEV)
    assert_same(A.T(), host_resort(A))


def test_pending_tuples_folded_first():
    I, J = _coo(7, 16, 16, 60)
    A = gt.csr_from_coo(I, J, _values(7, gt.FP64, len(I)), 16, 16,
                        sum_duplicates=False, device=DEV)
    A = A.setElement(2.5, 3, 15, blocking=False).setElement(
        -1.0, 15, 0, blocking=False).setElement(7.0, 3, 15,
                                                accum=gt.binary.plus[gt.FP64],
                                                blocking=False)
    assert A._pending
    At = A.T()
    assert_same(At, host_resort(A))
    assert At.extractElement(15, 3) == 9.5


def test_rows_out_of_column_order():
    """A row whose column indices are not sorted (a jumbled CSR): the
    stable sort by column still gives (column, row) order."""
    indptr = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    indices = torch.tensor([4, 0, 2, 3, 1, 5, 5, 5], dtype=torch.int32)
    rowids = torch.tensor([0, 0, 0, 2, 2, 3, 3, 3], dtype=torch.int32)
    values = torch.tensor([1., 2., 3., 4., 5., 0., 0., 0.],
                          dtype=torch.float64)
    A = CsrMatrix(indptr, indices, rowids, values, 5, 3, 5, gt.FP64)
    At = A.T()
    assert_same(At, host_resort(A))
    assert At.indptr.tolist() == [0, 1, 2, 3, 4, 5]
    assert At.indices[:5].tolist() == [0, 2, 0, 2, 0]


def test_twice_is_the_matrix_and_csc_round_trips():
    I, J = _coo(8, 25, 19, 150)
    A = gt.csr_from_coo(I, J, _values(8, gt.INT64, len(I)), 25, 19,
                        type=gt.INT64, sum_duplicates=False, device=DEV)
    assert_same(A.T().T(), A)
    C = gt.CscMatrix.from_csr(A)
    assert_same(C.tr, host_resort(A))
    assert_same(C.to_csr(), A)


def test_host_pattern_copied_back_once_on_demand():
    """The transpose reads nothing back; a reader's first index copies
    both arrays (two reads), later readers reuse them, and the pair is
    the one ``csr_from_coo`` keeps."""
    I, J = _coo(9, 30, 30, 200)
    A = gt.csr_from_coo(I, J, np.ones(len(I), bool), 30, 30, type=gt.BOOL,
                        sum_duplicates=False, device=DEV)
    counters.reset()
    At = A.T()
    hp = At._options["host_pattern"]
    assert isinstance(hp, HostPattern) and len(hp) == 2
    assert counters.stats()["counts"] == {"transpose.entries": A.nvals}
    want = host_resort(A)._options["host_pattern"]
    rows, cols = hp
    assert rows.dtype == cols.dtype == np.int32
    assert np.array_equal(rows, want[0]) and np.array_equal(cols, want[1])
    assert np.array_equal(hp[1][:At.nvals], want[1][:At.nvals])
    st = counters.stats()["counts"]
    assert st["reads"] == 2
    assert st["d2h_bytes"] == rows.nbytes + cols.nbytes
    counters.reset()


def test_transpose_keeps_engine_gates():
    """A transpose carries a host pattern, as the host resort's did, so
    the exact flop count's gate and the engine chosen are unchanged."""
    I, J = _coo(10, 64, 64, 500)
    X = np.random.default_rng(10).random(len(I))
    A = gt.csr_from_coo(I, J, X, 64, 64, sum_duplicates=False, device=DEV)
    e = np.zeros(0, np.int64)
    outs = []
    for At in (A.T(), host_resort(A)):
        C = gt.csr_from_coo(e, e, np.zeros(0), 64, 64, device=DEV)
        counters.reset()
        R = gt.mxm(C, None, None, "plus_times", At, A)
        outs.append((gt.last_axb_method(), counters.stats()["counts"].get(
            "flopcount.exact"), R.extractTuples()))
    (m0, f0, t0), (m1, f1, t1) = outs
    assert m0 == m1 and f0 == f1 == 1
    for a, b in zip(t0, t1):
        np.testing.assert_array_equal(a, b)
    counters.reset()
