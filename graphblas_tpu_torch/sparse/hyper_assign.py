"""assign / subassign / extract on the hypersparse container.

Counterpart of ``graphblas_tpu/sparse/hyper_assign.py``.  Reference:
``GB_subassign_kernel.c:10-62`` (format-agnostic there) and
``GB_assign.c``; executable specs ``Test/GB_spec_assign.m`` /
``GB_spec_subassign.m``.  The CSR forms (:mod:`.assign`) build O(dim)
index maps, impossible at dimension 2^60.  Here every key is a pair
(two stable sorts) and the index maps are ``searchsorted`` probes of the
sorted index lists, on the container's device:

* **inverse map** (``GB_I_inverse.c``): the position of a global id in
  the index list I by ``searchsorted(sort(I), g)`` and a gather of the
  sort's permutation: O(|I| log |I|) to build, never O(dim);
* **forward map**: a gather ``I[local]``;
* **region split**: per-lane membership of C's entries in I x J by two
  probes;
* the epilogue is :func:`~.hyper.hyper_accum_mask`.

``I = None`` (GrB_ALL) is the identity map, so whole-matrix assign
works at any dimension without an index list.  Duplicate indices raise
``InvalidValue`` (assign with them is undefined in the spec).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch, IndexOutOfBounds, InvalidValue
from ..core.ops import BinaryOp
from ..core.types import Type, cast_value, full_typed
from ..utils.tree import tree_map
from .hyper import (HyperMatrix, _filter, _live, _sorted_assemble,
                    hyper_accum_mask, hyper_from_coo)

__all__ = ["hyper_subref", "hyper_extract", "hyper_assign",
           "hyper_subassign", "hyper_filter_lanes"]


# ---------------------------------------------------------------------------
# index lists at huge dimension
# ---------------------------------------------------------------------------

class _IndexMap:
    """One side's index list I with sorted probe tensors on ``device``.
    ``ids=None`` is GrB_ALL: identity maps over the full dimension."""

    def __init__(self, ids, dim: int, what: str, device):
        self.dim = dim
        if ids is None:
            self.ids = None
            self.n = dim
            return
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 1:
            raise InvalidValue(f"{what} index list must be 1-D")
        if ids.size and (ids.min() < 0 or ids.max() >= dim):
            raise IndexOutOfBounds(
                f"{what} indices out of range for dimension {dim}")
        self.ids = ids
        self.n = len(ids)
        order = np.argsort(ids, kind="stable")
        srt = ids[order]
        if len(srt) > 1 and np.any(srt[1:] == srt[:-1]):
            raise InvalidValue(
                f"duplicate {what} indices are not supported on the "
                f"sparse containers (undefined for assign per the "
                f"GraphBLAS spec)")
        self.sorted = torch.from_numpy(srt).to(device)
        self.order = torch.from_numpy(order.astype(np.int64)).to(device)
        self.fwd = torch.from_numpy(ids).to(device)

    def inverse(self, g: torch.Tensor):
        """(local position, valid) of global ids g: device probes."""
        if self.ids is None:
            return g, g < self.dim
        if self.n == 0:
            return torch.zeros_like(g), torch.zeros(g.shape, dtype=torch.bool,
                                                    device=g.device)
        k = torch.searchsorted(self.sorted, g)
        kc = k.clamp(max=self.n - 1)
        return self.order[kc], self.sorted[kc] == g

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        """Global ids of local positions (a gather)."""
        if self.ids is None:
            return local
        return self.fwd[local.clamp(0, max(self.n - 1, 0))]


# ---------------------------------------------------------------------------
# device compaction: (i, j, vals, keep) -> HyperMatrix
# ---------------------------------------------------------------------------

def _compact(i, j, vals, keep, nrows: int, ncols: int,
             t: Type) -> HyperMatrix:
    """The kept lanes (unique pairs in any order) sorted into a
    HyperMatrix."""
    return _sorted_assemble(i[keep], j[keep],
                            tree_map(lambda v: v[keep], vals), nrows, ncols,
                            t)


def hyper_filter_lanes(A: HyperMatrix, keep) -> HyperMatrix:
    """Device-side entry filter on the hypersparse container (the
    pair-key form of :func:`~.tri.csr_filter_lanes`); ``keep`` covers
    the padded lanes.  A filter of a sorted list needs no re-sort."""
    keep = torch.as_tensor(keep, dtype=torch.bool, device=A.device)
    return _filter(A, keep.expand(A.nzmax)[:A.nvals])


# ---------------------------------------------------------------------------
# subref / to-global / region split
# ---------------------------------------------------------------------------

def hyper_subref(A: HyperMatrix, I: Any = None, J: Any = None
                 ) -> HyperMatrix:
    """C = A(I,J): inverse-map probes + pair-sort compaction
    (``GB_subref_template.c`` with searchsorted instead of buckets)."""
    A = A.wait()
    im = _IndexMap(I, A.nrows, "row", A.device)
    jm = _IndexMap(J, A.ncols, "column", A.device)
    li, vi = im.inverse(A.rowids)
    lj, vj = jm.inverse(A.indices)
    keep = _live(A) & vi & vj
    return _compact(li, lj, A.values, keep, im.n, jm.n, A.type)


def _to_global(A: HyperMatrix, im: _IndexMap, jm: _IndexMap,
               m: int, n: int) -> HyperMatrix:
    """Push the region-shaped A into C's m x n frame through I and J."""
    return _compact(im.forward(A.rowids), jm.forward(A.indices), A.values,
                    _live(A), m, n, A.type)


def _region_lanes(C: HyperMatrix, im: _IndexMap,
                  jm: _IndexMap) -> torch.Tensor:
    _, vi = im.inverse(C.rowids)
    _, vj = jm.inverse(C.indices)
    return _live(C) & vi & vj


def _union_disjoint(X: HyperMatrix, Y: HyperMatrix) -> HyperMatrix:
    """Merge two HyperMatrix with disjoint patterns."""
    if X.nvals == 0:
        return Y
    if Y.nvals == 0:
        return X
    nx, ny = X.nvals, Y.nvals
    return _sorted_assemble(
        torch.cat([X.rowids[:nx], Y.rowids[:ny]]),
        torch.cat([X.indices[:nx], Y.indices[:ny]]),
        tree_map(lambda x, y: torch.cat([x[:nx], y[:ny]]), X.values,
                 Y.values), X.nrows, X.ncols, X.type)


def _scalar_region(scalar, ni: int, nj: int, t: Type,
                   device) -> HyperMatrix:
    """Scalar expansion: the all-present ni x nj region
    (``GB_subassign_scalar.c``'s implicit A)."""
    if ni * nj > (1 << 24):
        raise InvalidValue(
            f"scalar assign would expand to {ni}x{nj} dense entries; "
            f"pass explicit index lists on the hypersparse container")
    v = cast_value(scalar, t)
    nnz = ni * nj
    I = np.repeat(np.arange(ni, dtype=np.int64), nj)
    J = np.tile(np.arange(nj, dtype=np.int64), ni)
    if t.is_udt:
        from ..core.matrix import host_values
        X = host_values(full_typed(nnz, v, t, "cpu"), t)
    else:
        X = np.full(nnz, v, np.dtype(t.dtype))
    return hyper_from_coo(I, J, X, ni, nj, type=t, dup=None, device=device)


# ---------------------------------------------------------------------------
# the orchestrators (GB_spec_subassign.m / GB_spec_assign.m transcribed)
# ---------------------------------------------------------------------------

def _prep_operand(A, im: _IndexMap, jm: _IndexMap, C: HyperMatrix,
                  tran: bool, scalar: bool) -> HyperMatrix:
    if scalar:
        return _scalar_region(A, im.n, jm.n, C.type, C.device)
    from ..ops.containers import to_hyper_operand
    A = to_hyper_operand(A, tran, "assign input")
    if A.shape != (im.n, jm.n):
        raise DimensionMismatch(
            f"A is {A.shape}, I x J is {(im.n, jm.n)}")
    return A


def _prep_mask(M, shape) -> Optional[HyperMatrix]:
    if M is None:
        return None
    from ..ops.containers import to_hyper_operand
    M = to_hyper_operand(M, False, "mask")
    if M.shape != shape:
        raise DimensionMismatch(f"mask is {M.shape}, expected {shape}")
    return M


def _split(C: HyperMatrix, im: _IndexMap, jm: _IndexMap):
    """(C inside I x J, C outside it)."""
    in_region = _region_lanes(C, im, jm)
    return hyper_filter_lanes(C, in_region), hyper_filter_lanes(
        C, ~in_region)


def hyper_subassign(C: HyperMatrix, M, accum: Optional[BinaryOp], A,
                    I: Any = None, J: Any = None,
                    desc: Optional[Descriptor] = None, *,
                    scalar: bool = False) -> HyperMatrix:
    """C(I,J)<M> = accum(C(I,J), A): GxB_subassign at hypersparse
    dimension.  M is |I| x |J|; REPLACE and the mask never touch entries
    outside the region (``GB_spec_subassign.m``)."""
    d = desc_of(desc)
    C = C.wait()
    im = _IndexMap(I, C.nrows, "row", C.device)
    jm = _IndexMap(J, C.ncols, "column", C.device)
    A = _prep_operand(A, im, jm, C, d.tran0, scalar)
    M = _prep_mask(M, (im.n, jm.n))
    C_in, C_out = _split(C, im, jm)
    T = _to_global(A, im, jm, C.nrows, C.ncols)
    Mg = _to_global(M, im, jm, C.nrows, C.ncols) if M is not None \
        else None
    Z_in = hyper_accum_mask(C_in, Mg, T, accum, replace=d.replace,
                            complement=d.mask_scmp,
                            structural=d.mask_structure)
    return _union_disjoint(Z_in, C_out)


def hyper_assign(C: HyperMatrix, M, accum: Optional[BinaryOp], A,
                 I: Any = None, J: Any = None,
                 desc: Optional[Descriptor] = None, *,
                 scalar: bool = False) -> HyperMatrix:
    """C<M>(I,J) = accum(C(I,J), A): GrB_assign at hypersparse
    dimension.  M is C-sized; REPLACE acts over all of C
    (``GB_spec_assign.m``: Z = C; Z(I,J) = accum(C(I,J), A);
    C<M,replace> = Z)."""
    d = desc_of(desc)
    C = C.wait()
    im = _IndexMap(I, C.nrows, "row", C.device)
    jm = _IndexMap(J, C.ncols, "column", C.device)
    A = _prep_operand(A, im, jm, C, d.tran0, scalar)
    M = _prep_mask(M, C.shape)
    C_in, C_out = _split(C, im, jm)
    T = _to_global(A, im, jm, C.nrows, C.ncols)
    # Z(I,J) = accum(C(I,J), A): region-local, no mask, no replace
    Z = _union_disjoint(hyper_accum_mask(C_in, None, T, accum), C_out)
    # C<M,d> = Z over ALL of C
    return hyper_accum_mask(C, M, Z, None, replace=d.replace,
                            complement=d.mask_scmp,
                            structural=d.mask_structure)


def hyper_extract(C: HyperMatrix, M, accum: Optional[BinaryOp], A,
                  I: Any = None, J: Any = None,
                  desc: Optional[Descriptor] = None) -> HyperMatrix:
    """C<M> = accum(C, A(I,J)): GrB_Matrix_extract at hypersparse
    dimension."""
    d = desc_of(desc)
    from ..ops.containers import to_hyper_operand
    A = to_hyper_operand(A, d.tran0, "extract input")
    T = hyper_subref(A, I, J)
    if T.shape != C.shape:
        raise DimensionMismatch(f"C is {C.shape}, A(I,J) is {T.shape}")
    M = _prep_mask(M, C.shape)
    return hyper_accum_mask(C, M, T, accum, replace=d.replace,
                            complement=d.mask_scmp,
                            structural=d.mask_structure)
