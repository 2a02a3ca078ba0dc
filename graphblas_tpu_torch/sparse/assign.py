"""Sparse assign / subassign / extract on the CSR container.

Counterpart of ``graphblas_tpu/sparse/assign.py``.  Reference:
``Source/GB_assign.c`` (GrB semantics — the mask covers all of C),
``Source/GB_subassign_kernel.c`` (GxB — the mask covers only C(I,J)),
and ``Template/GB_subref_template.c`` (extraction); executable specs
``Test/GB_spec_assign.m`` / ``GB_spec_subassign.m``.

The reference's 48-case subassign kernel is a scatter machine with
zombies and pending tuples.  Here it is three coordinate transforms plus
the one sparse epilogue that already exists
(:func:`graphblas_tpu_torch.sparse.mask.csr_accum_mask`):

  * **subref** — remap A's entries through the inverse index maps
    (``GB_I_inverse.c`` analogue) and compact: C = A(I,J).
  * **to-global** — push a region-shaped operand's entries through the
    forward maps ``I``/``J`` into C's frame.
  * **region split** — partition C's lanes into inside/outside the
    I x J region, so region-scoped REPLACE (GxB) and C-scoped REPLACE
    (GrB) each touch exactly the entries the spec says.

GxB_subassign:  C = (C_out) ∪ epilogue(C_in, M→global, A→global)
GrB_assign:     Z = (C_out) ∪ accum(C_in, A→global);  C = mask(C, M, Z)

Everything is device work on padded lanes (a stable sort by the new
int32 or int64 key, gathers and a row count); the only host work is
building the O(dim) index maps.  Duplicate indices raise
``InvalidValue``: assign with them is undefined in the spec, and
extraction with them takes the bitmap container.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch, InvalidValue
from ..core.ops import BinaryOp
from ..core.types import Type, cast_value, full_typed, value_take
from ..utils.tree import tree_map
from ..utils.indices import normalize_indices
from .container import CsrMatrix
from .esc import _bucket, _empty_csr
from .mask import csr_accum_mask
from .tri import csr_filter_lanes

__all__ = ["csr_subref", "csr_extract", "csr_assign", "csr_subassign",
           "csr_assign_scalar", "csr_subassign_scalar"]


def _key_dtype(m: int, n: int):
    if (m + 1) * (n + 1) < (1 << 31):
        return torch.int32
    if (m + 1) * (n + 1) < (1 << 63):
        return torch.int64
    raise NotImplementedError("dimension product exceeds 2^63")


def _compact(keys: torch.Tensor, values: torch.Tensor, m_out: int,
             n_out: int, kdt):
    """Sort the lanes by key (dropped lanes hold the key type's max and
    fall to the tail) and rebuild the CSR arrays: (indptr, indices,
    rowids, values, nnz)."""
    big = torch.iinfo(kdt).max
    ks, perm = torch.sort(keys, stable=True)
    vs = value_take(values, perm)
    is_live = ks < big
    oi = torch.where(is_live, ks // n_out, m_out).to(torch.int32)
    oj = torch.where(is_live, ks % n_out, n_out).to(torch.int32)
    nnz = int(is_live.sum())
    counts = torch.bincount(oi[:nnz].long(), minlength=m_out)
    indptr = torch.zeros(m_out + 1, dtype=torch.int32, device=keys.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, oj, oi, vs, nnz


def _map_compact(A: CsrMatrix, row_map, col_map, m_out: int,
                 n_out: int) -> CsrMatrix:
    """Remap A's lanes through the host row/col maps (-1 = drop; the
    extra last slot serves the padded lanes) and compact to CSR."""
    if m_out == 0 or n_out == 0 or A.nvals == 0:
        return _empty_csr(m_out, n_out, A.type, A.device)
    dev = A.device
    kdt = _key_dtype(m_out, n_out)
    big = torch.iinfo(kdt).max
    rmap = torch.from_numpy(np.asarray(row_map, np.int64)).to(dev)
    cmap = torch.from_numpy(np.asarray(col_map, np.int64)).to(dev)
    rr = rmap[A.rowids.long().clamp(max=rmap.shape[0] - 1)]
    cc = cmap[A.indices.long().clamp(max=cmap.shape[0] - 1)]
    live = torch.arange(A.nzmax, device=dev) < A.nvals
    keep = live & (rr >= 0) & (cc >= 0)
    key = torch.where(keep, rr.to(kdt) * n_out + cc.to(kdt), big)
    indptr, oj, oi, ov, n = _compact(key, A.values, m_out, n_out, kdt)
    cap = min(_bucket(max(n, 8)), A.nzmax)
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     tree_map(lambda v: v[:cap], ov), n, m_out, n_out,
                     A.type)


def _inverse_map(idx: np.ndarray, n: int, what: str) -> np.ndarray:
    """inv[g] = position of g in idx, or -1 (``GB_I_inverse.c``); the
    one-extra slot keeps padded-lane gathers in range."""
    if len(np.unique(idx)) != len(idx):
        raise InvalidValue(
            f"duplicate {what} indices are not supported on the sparse "
            f"container (undefined for assign per the GraphBLAS spec; "
            f"use the bitmap backend for duplicate extract indices)")
    inv = np.full(n + 1, -1, np.int64)
    inv[idx] = np.arange(len(idx))
    return inv


def _forward_map(idx: np.ndarray) -> np.ndarray:
    """fwd[local] = global index; sentinel slot -1 for padded lanes."""
    return np.concatenate([idx.astype(np.int64), [-1]])


def _region_lanes(C: CsrMatrix, inv_r, inv_c) -> torch.Tensor:
    """Boolean per-lane membership of C's entries in the I x J region."""
    dev = C.device
    live = torch.arange(C.nzmax, device=dev) < C.nvals
    rr = torch.from_numpy(inv_r).to(dev)[C.rowids.long().clamp(max=C.nrows)]
    cc = torch.from_numpy(inv_c).to(dev)[C.indices.long().clamp(max=C.ncols)]
    return live & (rr >= 0) & (cc >= 0)


def _union_disjoint(X: CsrMatrix, Y: CsrMatrix) -> CsrMatrix:
    """Merge two CsrMatrix with disjoint patterns (one sort, no fold)."""
    m, n = X.shape
    if m == 0 or n == 0:
        return _empty_csr(m, n, X.type, X.device)
    if X.nvals == 0:
        return Y
    if Y.nvals == 0:
        return X
    kdt = _key_dtype(m, n)
    big = torch.iinfo(kdt).max

    def keys_of(Z):
        live = torch.arange(Z.nzmax, device=Z.device) < Z.nvals
        k = Z.rowids.to(kdt) * n + Z.indices.to(kdt)
        return torch.where(live, k, big)

    keys = torch.cat([keys_of(X), keys_of(Y)])
    vals = tree_map(lambda x, y: torch.cat([x, y]), X.values, Y.values)
    E = X.nzmax + Y.nzmax
    indptr, oj, oi, ov, nv = _compact(keys, vals, m, n, kdt)
    cap = min(_bucket(max(nv, 8)), E)
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     tree_map(lambda v: v[:cap], ov), nv, m, n, X.type)


def _scalar_region(scalar, ni: int, nj: int, t: Type, device) -> CsrMatrix:
    """Scalar expansion: the all-present ni x nj region as CSR
    (``GB_subassign_scalar.c``'s implicit A)."""
    nnz = ni * nj
    cap = _bucket(max(nnz, 8))
    lane = torch.arange(cap, device=device)
    live = lane < nnz
    rows = torch.where(live, lane // max(nj, 1), ni).to(torch.int32)
    cols = torch.where(live, lane % max(nj, 1), nj).to(torch.int32)
    vals = full_typed((cap,), cast_value(scalar, t), t, device)
    indptr = torch.arange(ni + 1, dtype=torch.int32, device=device) * nj
    return CsrMatrix(indptr, cols, rows, vals, nnz, ni, nj, t)


def csr_subref(A: CsrMatrix, I: Any = None, J: Any = None) -> CsrMatrix:
    """C = A(I,J): the symbolic+numeric subref in one remap-compact."""
    A = A.wait()
    Ii = normalize_indices(I, A.nrows)
    Jj = normalize_indices(J, A.ncols)
    inv_r = _inverse_map(Ii, A.nrows, "row")
    inv_c = _inverse_map(Jj, A.ncols, "column")
    return _map_compact(A, inv_r, inv_c, len(Ii), len(Jj))


def _to_global(A: CsrMatrix, Ii: np.ndarray, Jj: np.ndarray,
               m: int, n: int) -> CsrMatrix:
    """Push the region-shaped A into C's m x n frame via I/J."""
    return _map_compact(A, _forward_map(Ii), _forward_map(Jj), m, n)


def _prep_operand(A, Ii, Jj, ctype: Type, tran: bool, scalar: bool,
                  device):
    if scalar:
        return _scalar_region(A, len(Ii), len(Jj), ctype, device)
    from ..ops.containers import to_csr_operand
    A = to_csr_operand(A, tran, "assign input")
    if A.shape != (len(Ii), len(Jj)):
        raise DimensionMismatch(
            f"A is {A.shape}, I x J is {(len(Ii), len(Jj))}")
    return A


def _prep_mask(M, shape):
    if M is None:
        return None
    from ..ops.containers import to_csr_operand
    M = to_csr_operand(M, False, "mask")
    if M.shape != shape:
        raise DimensionMismatch(f"mask is {M.shape}, expected {shape}")
    return M


def _split(C: CsrMatrix, Ii: np.ndarray, Jj: np.ndarray):
    """(C_in, C_out): C's entries inside and outside the I x J region."""
    inv_r = _inverse_map(Ii, C.nrows, "row")
    inv_c = _inverse_map(Jj, C.ncols, "column")
    in_region = _region_lanes(C, inv_r, inv_c)
    return csr_filter_lanes(C, in_region), csr_filter_lanes(C, ~in_region)


def csr_subassign(C: CsrMatrix, M, accum: Optional[BinaryOp], A,
                  I: Any = None, J: Any = None,
                  desc: Optional[Descriptor] = None, *,
                  scalar: bool = False) -> CsrMatrix:
    """C(I,J)<M> = accum(C(I,J), A) — GxB_subassign on CSR.  M is
    |I| x |J|; REPLACE and the mask never touch entries outside the
    region (``GB_spec_subassign.m``)."""
    d = desc_of(desc)
    C = C.wait()
    Ii = normalize_indices(I, C.nrows, unique=scalar)
    Jj = normalize_indices(J, C.ncols, unique=scalar)
    A = _prep_operand(A, Ii, Jj, C.type, d.tran0, scalar, C.device)
    M = _prep_mask(M, (len(Ii), len(Jj)))
    C_in, C_out = _split(C, Ii, Jj)
    T = _to_global(A, Ii, Jj, C.nrows, C.ncols)
    Mg = (_to_global(M, Ii, Jj, C.nrows, C.ncols)
          if M is not None else None)
    Z_in = csr_accum_mask(C_in, Mg, T, accum, d)
    return _union_disjoint(Z_in, C_out)


def csr_assign(C: CsrMatrix, M, accum: Optional[BinaryOp], A,
               I: Any = None, J: Any = None,
               desc: Optional[Descriptor] = None, *,
               scalar: bool = False) -> CsrMatrix:
    """C<M>(I,J) = accum(C(I,J), A) — GrB_assign on CSR.  M is C-sized;
    REPLACE acts over all of C (``GB_spec_assign.m``: Z = C;
    Z(I,J) = accum(C(I,J),A); C<M,replace> = Z)."""
    d = desc_of(desc)
    C = C.wait()
    Ii = normalize_indices(I, C.nrows, unique=scalar)
    Jj = normalize_indices(J, C.ncols, unique=scalar)
    A = _prep_operand(A, Ii, Jj, C.type, d.tran0, scalar, C.device)
    M = _prep_mask(M, C.shape)
    C_in, C_out = _split(C, Ii, Jj)
    T = _to_global(A, Ii, Jj, C.nrows, C.ncols)
    # Z(I,J) = accum(C(I,J), A): region-local, no mask, no replace
    Z_in = csr_accum_mask(C_in, None, T, accum, None)
    Z = _union_disjoint(Z_in, C_out)
    # C<M,d> = Z over ALL of C
    return csr_accum_mask(C, M, Z, None, d)


def csr_assign_scalar(C, M, accum, x, I=None, J=None, desc=None):
    return csr_assign(C, M, accum, x, I, J, desc, scalar=True)


def csr_subassign_scalar(C, M, accum, x, I=None, J=None, desc=None):
    return csr_subassign(C, M, accum, x, I, J, desc, scalar=True)


def csr_extract(C: CsrMatrix, M, accum: Optional[BinaryOp], A,
                I: Any = None, J: Any = None,
                desc: Optional[Descriptor] = None) -> CsrMatrix:
    """C<M> = accum(C, A(I,J)) — GrB_Matrix_extract on CSR."""
    d = desc_of(desc)
    from ..ops.containers import to_csr_operand
    C = C.wait()
    A = to_csr_operand(A, d.tran0, "extract input")
    T = csr_subref(A, I, J)
    if T.shape != C.shape:
        raise DimensionMismatch(
            f"C is {C.shape}, A(I,J) is {T.shape}")
    M = _prep_mask(M, C.shape)
    return csr_accum_mask(C, M, T, accum, d)
