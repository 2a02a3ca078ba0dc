"""Hypersparse container: huge-dimension matrices at O(nnz + nvec).

Counterpart of ``graphblas_tpu/sparse/hyper.py``.  The reference stores
hypersparse matrices as doubly-compressed CSR: ``h`` lists the
non-empty vectors, ``p`` points into them, which makes a dimension up
to 2^60 feasible (``Source/Template/GB_matrix.h:41-132, 216-246``,
``GB.h:314-323``).  The padded CSR container keeps an O(nrows)
``indptr``; this one does not.

Layout (the JAX package's): sorted int64 COO ``rowids``/``indices``
with ``values``, padded to ``nzmax`` (a multiple of 128; pads hold
``nrows``/``ncols`` and 0), the present-row list ``h`` [hcap] (pad
``nrows``) and the row pointers ``hptr`` [hcap+1] int32 (pad
``nvals``).  No tensor is ever sized by a dimension.

* There is no linearized ``i*ncols+j`` key: at dimension 2^60 it
  overflows int64.  Every sort is two stable ``torch.sort`` passes (j,
  then i, :func:`_pair_argsort`) and set membership is a tagged
  combined sort (:func:`_pair_member`).  Lanes outside a set carry
  int64 max, and no arithmetic touches them.
* SpGEMM is the ESC formulation re-derived for pair keys: a B row is
  found by ``searchsorted`` on ``B.h``, the expansion is a
  ``repeat_interleave`` of the per-entry B-row lengths, products sort by
  (i, j), the add monoid folds the segments (``segment_reduce``), and
  ``h``/``hptr`` are rebuilt on the device.  Above the ESC lane cap (a
  memory bound) a product whose dimensions admit an O(nrows) indptr
  runs on the chunked CSR engine; a larger one raises.
* Compaction writes only the lanes it keeps (a boolean selection in
  order), never a shared sink slot.

The JAX package re-sorts the tuples of ``hyper_select``,
``hyper_transpose`` and ``hyper_accum_mask`` on the host (numpy
``lexsort`` in ``hyper_from_coo``).  The pairs are unique, so the same
two-pass stable sort on the operands' device gives the same arrays; the
port sorts there.  ``hyper_from_coo`` sorts host tuples on the target
device too, and folds duplicates on the host exactly as the JAX
package does (numpy ``reduceat`` over the values in their own dtype,
so an unsigned MIN/MAX folds in the unsigned order).

Every reduction folds through ``segment_reduce``: LOR/LAND by the op
(0/1), float MIN/MAX ignoring NaN.  The JAX package's hypersparse
reduce folds LOR/LAND by a max/min of the values.

Struct values of a user-defined type ride every engine leaf by leaf
(the pair sorts permute every field, the generic segmented fold reduces
them); a build from tuples over such a type takes duplicate-free tuples
only.  The JAX package's hypersparse containers refuse user-defined
types in its element-wise ops and pending fold; the port runs them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.matrix import as_pending
from ..core.monoids import Monoid
from ..core.ops import BinaryOp
from ..core.semirings import Semiring
from ..core.matrix import host_values
from ..core.types import (Type, cast, cast_result, tree_where, type_of_dtype,
                          value_take, zeros_like_typed)
from ..utils import faultinject
from ..utils.tree import tree_map
from .container import resolve_device
from .spmv import segment_fold, segment_reduce

__all__ = ["HyperMatrix", "hyper_from_coo", "hyper_spgemm",
           "hyper_ewise", "hyper_mxv", "hyper_reduce_scalar",
           "hyper_reduce_vector", "hyper_apply", "hyper_select",
           "hyper_transpose", "hyper_accum_mask", "hyper_conform",
           "nvec_nonempty", "cast_host", "GxB_INDEX_MAX",
           "GxB_HYPER_DEFAULT", "GxB_ALWAYS_HYPER", "GxB_NEVER_HYPER"]

#: reference dimension cap (``GB.h:314-323``): indices stay strictly
#: below 2^60, so sentinels and flips never overflow int64
GxB_INDEX_MAX = 1 << 60

_I64MAX = torch.iinfo(torch.int64).max


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class HyperMatrix:
    """Hypersparse container (doubly-compressed sorted COO) on torch
    tensors.

    ``h`` [hcap] int64 sorted present-row ids (pad ``nrows``); ``hptr``
    [hcap+1] int32 entry pointers of the present rows (pad ``nvals``);
    ``rowids``/``indices`` [nzmax] int64 sorted (i, j) (pads ``nrows``
    / ``ncols``); ``values`` [nzmax] in the type's storage.  ``nrows``
    and ``ncols`` may be up to ``GxB_INDEX_MAX``.  Element mutation is
    functional, as on the CSR container: ``setElement`` adds a pending
    tuple, ``wait`` folds them (:mod:`.pending`)."""

    __slots__ = ("h", "hptr", "rowids", "indices", "values",
                 "nvals", "nvec", "nrows", "ncols", "type", "_options",
                 "_pending")

    def __init__(self, h, hptr, rowids, indices, values, nvals: int,
                 nvec: int, nrows: int, ncols: int, type: Type,
                 pending=None):
        self.h = h
        self.hptr = hptr
        self.rowids = rowids
        self.indices = indices
        self.values = values
        self.nvals = int(nvals)
        self.nvec = int(nvec)
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.type = type
        self._options = {}
        # the non-blocking delta list (GB_pending_add analogue)
        self._pending = as_pending(pending)

    def _shallow(self) -> "HyperMatrix":
        out = HyperMatrix(self.h, self.hptr, self.rowids, self.indices,
                          self.values, self.nvals, self.nvec, self.nrows,
                          self.ncols, self.type, pending=self._pending)
        out._options = dict(self._options)
        return out

    # -- pending tuples / element mutation (GB_setElement + GB_wait) ------
    def wait(self) -> "HyperMatrix":
        """Fold the pending delta list (reference ``GB_wait``)."""
        if not self._pending:
            return self
        from .pending import fold_pending_hyper
        return fold_pending_hyper(self)

    def setElement(self, value, i: int, j: int, *, accum=None,
                   blocking=None) -> "HyperMatrix":
        from .pending import append_pending
        return append_pending(self, i, j, value, accum, blocking)

    def extractElement(self, i: int, j: int):
        """The value at (i, j) as a numpy scalar, or None for
        GrB_NO_VALUE: a search of ``h``, then of the row, on the
        device; only scalars and the row slice cross to the host."""
        from .pending import check_index
        check_index(self, i, j)
        A = self.wait()
        if A.nvec == 0:
            return None
        hv = A.h[:A.nvec]
        k = int(torch.searchsorted(hv, torch.tensor(
            [int(i)], dtype=torch.int64, device=hv.device))[0])
        if k >= A.nvec or int(hv[k]) != int(i):
            return None
        s, e = (int(x) for x in A.hptr[k:k + 2].cpu())
        row = A.indices[s:e].cpu().numpy()
        pos = int(np.searchsorted(row, j))
        if pos >= len(row) or row[pos] != j:
            return None
        return tree_map(lambda a: a[0], host_values(
            value_take(A.values, slice(s + pos, s + pos + 1)), A.type))

    def removeElement(self, i: int, j: int) -> "HyperMatrix":
        """Delete one entry: a device filter of the lanes."""
        from .pending import check_index
        check_index(self, i, j)
        A = self.wait()
        n = A.nvals
        return _filter(A, ~((A.rowids[:n] == int(i))
                            & (A.indices[:n] == int(j))))

    def resize(self, nrows_new: int, ncols_new: int) -> "HyperMatrix":
        from .pending import hyper_resize
        return hyper_resize(self, nrows_new, ncols_new)

    def clear(self) -> "HyperMatrix":
        return _empty_hyper(self.nrows, self.ncols, self.type, self.device)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nzmax(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indices.device

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_coo(I, J, X, nrows: int, ncols: int,
                 type: Optional[Type] = None, dup: Optional[str] = "PLUS",
                 device=None) -> "HyperMatrix":
        return hyper_from_coo(I, J, X, nrows, ncols, type=type, dup=dup,
                              device=device)

    @staticmethod
    def from_csr(A) -> "HyperMatrix":
        """CsrMatrix -> hypersparse on A's device: the CSR entry order is
        the sorted (i, j) order, so only h/hptr are derived."""
        A = A.wait()
        n = A.nvals
        return _assemble(A.rowids[:n].long(), A.indices[:n].long(),
                         value_take(A.values, slice(0, n)), A.nrows,
                         A.ncols, A.type)

    def to_csr(self):
        """Hypersparse -> padded CSR on the same device (nrows must admit
        an O(nrows) indptr)."""
        if self.nrows > (1 << 28):
            raise ValueError(
                f"nrows {self.nrows} too large for a CSR indptr; "
                "stay hypersparse")
        from .container import csr_from_coo
        I, J, X = self.extractTuples()
        return csr_from_coo(I, J, X, self.nrows, self.ncols,
                            type=self.type, sum_duplicates=False,
                            device=self.device)

    # -- accessors ----------------------------------------------------------
    def extractTuples(self):
        """(I, J, X) of the live entries as host arrays (int64 ids, X in
        the type's numpy dtype), pending tuples folded first."""
        A = self.wait()
        n = A.nvals
        return (A.rowids[:n].cpu().numpy(), A.indices[:n].cpu().numpy(),
                host_values(value_take(A.values, slice(0, n)), A.type))

    def rows_present(self) -> np.ndarray:
        return self.h[:self.nvec].cpu().numpy()

    def row_degrees(self) -> np.ndarray:
        """Degrees of the present rows (aligned with ``h``)."""
        p = self.hptr[:self.nvec + 1].cpu().numpy()
        return p[1:] - p[:-1]

    def __repr__(self):  # pragma: no cover
        return (f"HyperMatrix<{self.type.name}> "
                f"{self.nrows}x{self.ncols}, {self.nvals} entries in "
                f"{self.nvec} rows on {self.device}")


# ---------------------------------------------------------------------------
# device primitives: pair sort / membership / h-rebuild / assembly
# ---------------------------------------------------------------------------

def _pair_argsort(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort of (i, j) pairs: two stable
    single-key sorts (no linearized key: i*ncols+j overflows int64 at
    hypersparse dimensions)."""
    p1 = torch.sort(j, stable=True).indices
    p2 = torch.sort(i[p1], stable=True).indices
    return p1[p2]


def _pair_heads(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    head = torch.ones(i.shape[0], dtype=torch.bool, device=i.device)
    head[1:] = (i[1:] != i[:-1]) | (j[1:] != j[:-1])
    return head


def _pair_member(qi, qj, mi, mj, m_live) -> torch.Tensor:
    """bool[Eq]: is pair (qi, qj) among the live mask pairs?  A tagged
    combined sort: the mask lanes come first, so in each coordinate
    segment a mask lane sorts ahead of the query lanes.  Lanes outside
    the sets carry int64 max (dead query lanes are never members)."""
    nm = mi.shape[0]
    nq = qi.shape[0]
    dev = qi.device
    out = torch.zeros(nq, dtype=torch.bool, device=dev)
    if nq == 0 or nm == 0:
        return out
    ci = torch.cat([torch.where(m_live, mi, _I64MAX), qi])
    cj = torch.cat([torch.where(m_live, mj, _I64MAX), qj])
    perm = _pair_argsort(ci, cj)
    si, sj = ci[perm], cj[perm]
    head = _pair_heads(si, sj)
    seg = torch.cumsum(head, 0) - 1
    is_mask = perm < nm
    has_mask = torch.zeros(nm + nq, dtype=torch.int32, device=dev)
    has_mask.index_add_(0, seg, is_mask.to(torch.int32))
    member = (has_mask[seg] > 0) & ~is_mask & (si < _I64MAX)
    q = ~is_mask                      # query lanes: unique targets
    out[perm[q] - nm] = member[q]
    return out


def _build_h(out_i: torch.Tensor, nvals: int, nrows: int):
    """(h, hptr, nvec) of sorted output row ids (pad rows == nrows sort
    to the tail): the present-row list and its entry pointers, hcap a
    multiple of 128."""
    dev = out_i.device
    live = out_i < nrows
    row_head = torch.ones(out_i.shape[0], dtype=torch.bool, device=dev)
    row_head[1:] = out_i[1:] != out_i[:-1]
    row_head &= live
    starts = torch.nonzero(row_head).flatten()
    nvec = int(starts.shape[0])
    hcap = _round_up(max(nvec, 8), 128)
    h = torch.full((hcap,), nrows, dtype=torch.int64, device=dev)
    h[:nvec] = out_i[starts]
    hptr = torch.full((hcap + 1,), nvals, dtype=torch.int32, device=dev)
    hptr[:nvec] = starts.to(torch.int32)
    return h, hptr, nvec


def _assemble(I: torch.Tensor, J: torch.Tensor, X: torch.Tensor,
              nrows: int, ncols: int, t: Type) -> HyperMatrix:
    """HyperMatrix of sorted, duplicate-free live int64 pairs and values
    in ``t``'s storage, padded to a multiple of 128 lanes."""
    dev = I.device
    nvals = int(I.shape[0])
    cap = _round_up(max(nvals, 8), 128)
    rowids = torch.full((cap,), nrows, dtype=torch.int64, device=dev)
    indices = torch.full((cap,), ncols, dtype=torch.int64, device=dev)
    values = zeros_like_typed(cap, t, dev)
    rowids[:nvals] = I
    indices[:nvals] = J

    def put(v, x):
        v[:nvals] = x.to(v.dtype)
    tree_map(put, values, X)
    h, hptr, nvec = _build_h(rowids, nvals, nrows)
    return HyperMatrix(h, hptr, rowids, indices, values, nvals, nvec,
                       nrows, ncols, t)


def _sorted_assemble(I, J, X, nrows: int, ncols: int,
                     t: Type) -> HyperMatrix:
    """:func:`_assemble` of unique pairs in any order: one pair sort on
    their device first."""
    perm = _pair_argsort(I, J)
    return _assemble(I[perm], J[perm], value_take(X, perm), nrows, ncols, t)


def _live(A: HyperMatrix) -> torch.Tensor:
    return torch.arange(A.nzmax, device=A.device) < A.nvals


# ---------------------------------------------------------------------------
# build from tuples
# ---------------------------------------------------------------------------

_DUP_FOLDS = {"PLUS": np.add, "TIMES": np.multiply, "MIN": np.minimum,
              "MAX": np.maximum, "FIRST": None, "SECOND": None}


def _host_fold(I, J, X, dup: str):
    """The JAX package's host build: lexsort, then fold each run of one
    (i, j) with the dup operator (numpy ``reduceat`` in X's dtype)."""
    order = np.lexsort((J, I))
    I, J, X = I[order], J[order], X[order]
    same = (I[1:] == I[:-1]) & (J[1:] == J[:-1])
    nm = dup.upper()
    if nm not in _DUP_FOLDS:
        raise NotImplementedError(f"dup operator {nm}")
    first = np.concatenate([[True], ~same])
    starts = np.nonzero(first)[0]
    if nm == "FIRST":
        X = X[starts]
    elif nm == "SECOND":
        X = X[np.concatenate([starts[1:] - 1, [len(I) - 1]])]
    else:
        X = _DUP_FOLDS[nm].reduceat(X, starts)
    return I[starts], J[starts], X


def hyper_from_coo(I, J, X, nrows: int, ncols: int,
                   type: Optional[Type] = None,
                   dup: Optional[str] = "PLUS", device=None) -> HyperMatrix:
    """Hypersparse build from host tuples on ``device`` (see
    :func:`~.container.resolve_device`): pair sort, duplicate fold,
    h/hptr.  ``dup=None`` asserts the tuples are duplicate-free (the
    import and container-conversion paths).  Tuples with duplicates
    fold on the host, in input order within a run, as the JAX package
    folds them; unique tuples sort on the device."""
    faultinject.checkpoint("hyper_from_coo")
    from ..core.errors import IndexOutOfBounds
    device = resolve_device(device)
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    if type is not None and type.is_udt:
        return _hyper_from_coo_udt(I, J, X, nrows, ncols, type, dup, device)
    X = np.asarray(X)
    t = type or type_of_dtype(X.dtype)
    if (t.is_unsigned and X.dtype.kind == "i"
            and X.dtype.itemsize == t.dtype.itemsize):
        X = X.view(t.dtype)          # storage form: read as unsigned
    if not (0 < nrows <= GxB_INDEX_MAX and 0 < ncols <= GxB_INDEX_MAX):
        raise ValueError(
            f"dimensions must be in [1, 2^60], got {nrows}x{ncols}")
    if I.size:
        if I.min() < 0 or I.max() >= nrows or J.min() < 0 \
                or J.max() >= ncols:
            raise IndexOutOfBounds(
                f"tuple index out of range for {nrows}x{ncols}")
    Id = torch.from_numpy(I).to(device)
    Jd = torch.from_numpy(J).to(device)
    perm = _pair_argsort(Id, Jd)
    Id, Jd = Id[perm], Jd[perm]
    if dup is not None and I.size > 1:
        same = (Id[1:] == Id[:-1]) & (Jd[1:] == Jd[:-1])
        if bool(same.any()):
            I, J, X = _host_fold(I, J, X, dup)
            Id = torch.from_numpy(I).to(device)
            Jd = torch.from_numpy(J).to(device)
            perm = None
    Xd = torch.from_numpy(np.array(t.to_storage(X.astype(t.dtype,
                                                         copy=False))))
    Xd = Xd.to(device)
    if perm is not None:
        Xd = Xd[perm]
    return _assemble(Id, Jd, Xd, nrows, ncols, t)


def _hyper_from_coo_udt(I, J, X, nrows: int, ncols: int, t: Type, dup,
                        device) -> HyperMatrix:
    """The build over a user-defined type: duplicate-free tuples only
    (no default dup op folds structs), every field permuted by the one
    pair sort."""
    from ..core.errors import IndexOutOfBounds
    from ..core.matrix import device_values
    from .container import _udt_host
    if not (0 < nrows <= GxB_INDEX_MAX and 0 < ncols <= GxB_INDEX_MAX):
        raise ValueError(
            f"dimensions must be in [1, 2^60], got {nrows}x{ncols}")
    if I.size and (I.min() < 0 or I.max() >= nrows or J.min() < 0
                   or J.max() >= ncols):
        raise IndexOutOfBounds(f"tuple index out of range for "
                               f"{nrows}x{ncols}")
    Xd = device_values(_udt_host(X, t), t, device)
    Id = torch.from_numpy(I).to(device)
    Jd = torch.from_numpy(J).to(device)
    perm = _pair_argsort(Id, Jd)
    Id, Jd = Id[perm], Jd[perm]
    if I.size > 1 and bool(((Id[1:] == Id[:-1]) & (Jd[1:] == Jd[:-1]))
                           .any()):
        raise TypeError("struct (user-defined) tuples must be "
                        "duplicate-free: no default dup op folds them")
    return _assemble(Id, Jd, value_take(Xd, perm), nrows, ncols, t)


def _empty_hyper(nrows: int, ncols: int, t: Type, device) -> HyperMatrix:
    e = torch.zeros(0, dtype=torch.int64, device=device)
    return _assemble(e, e, zeros_like_typed(0, t, device), nrows, ncols, t)


# ---------------------------------------------------------------------------
# SpGEMM: hyper x hyper -> hyper, any semiring, O(flops)
# ---------------------------------------------------------------------------

def _hyper_flops(a_indices, b_h, b_hptr) -> torch.Tensor:
    """Per-A-entry B-row lengths through the compressed row lookup."""
    hcap = b_h.shape[0]
    k = torch.searchsorted(b_h, a_indices)
    kc = k.clamp(max=hcap - 1)
    present = b_h[kc] == a_indices
    lens = (b_hptr[kc + 1] - b_hptr[kc]).long()
    return torch.where(present, lens, 0), kc


def _hyper_esc_core(sr: Semiring, A: HyperMatrix, B: HyperMatrix,
                    mask: Optional[HyperMatrix], complement: bool,
                    structural: bool, lens: torch.Tensor,
                    kc: torch.Tensor, total: int):
    """Expand, (mask), multiply, sort by (i, j), fold, compact: the
    sorted output pairs and values (all live)."""
    dev = A.device
    eid = torch.nonzero(lens > 0).flatten()
    elens = lens[eid]
    ec = torch.repeat_interleave(eid, elens, output_size=total)
    starts = torch.cumsum(elens, 0) - elens
    pos0 = B.hptr[kc[eid]].long() - starts
    pos = torch.repeat_interleave(pos0, elens, output_size=total) \
        + torch.arange(total, device=dev)
    i = A.rowids[ec]
    j = B.indices[pos]
    if mask is not None:
        member = _pair_member(i, j, mask.rowids, mask.indices,
                              _truthy_lanes(mask, structural))
        keep = ~member if complement else member
        ec, pos, i, j = ec[keep], pos[keep], i[keep], j[keep]
    zt = sr.ztype
    a = cast(value_take(A.values, ec), sr.xtype, A.type)
    b = cast(value_take(B.values, pos), sr.ytype, B.type)
    z = cast_result(sr.mult(a, b), zt)
    perm = _pair_argsort(i, j)
    si, sj, zs = i[perm], j[perm], value_take(z, perm)
    head = _pair_heads(si, sj)
    seg = torch.cumsum(head, 0) - 1
    nnz = int(head.sum()) if si.shape[0] else 0
    vals = segment_fold(sr.add, zs, seg, nnz, zt)
    return si[head], sj[head], vals


def hyper_spgemm(sr: Semiring, A: HyperMatrix, B: HyperMatrix,
                 mask: Optional[HyperMatrix] = None,
                 complement: bool = False,
                 structural: bool = False) -> HyperMatrix:
    """C<M> = A *.sr* B on hypersparse operands: the ESC engine with pair
    keys.  Dimension-independent: only nnz- and nvec-sized tensors.
    Reads two scalars back (the flop total, the output count)."""
    faultinject.checkpoint("hyper_spgemm")
    from ..core.errors import DimensionMismatch
    from ..ops.flopcount import record_axb_method
    from . import esc
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (m, n):
        raise DimensionMismatch(f"mask {mask.shape} vs output {(m, n)}")
    zt = sr.ztype
    lens, kc = _hyper_flops(A.indices, B.h, B.hptr)
    lens = torch.where(_live(A), lens, 0)
    flops = int(lens.sum())
    if flops == 0 or (mask is not None and not complement
                      and mask.nvals == 0):
        return _empty_hyper(m, n, zt, A.device)
    if flops > esc._ESC_LANE_CAP:
        # one ESC program holds about a dozen lane-sized tensors; when
        # the dimensions admit an O(nrows) indptr, hand the product to
        # the lane-capped chunked CSR engine and convert back, else
        # raise rather than exhaust the device's memory
        from ..ops.containers import _CSR_DIM_CAP
        if max(m, k, n) <= _CSR_DIM_CAP:
            Ac, Bc = A.to_csr(), B.to_csr()
            Mc = mask.to_csr() if mask is not None else None
            C = esc.csr_spgemm(sr, Ac, Bc, mask=Mc, complement=complement,
                               structural=structural)
            return HyperMatrix.from_csr(C)
        raise NotImplementedError(
            f"hyper_spgemm: {flops} expansion lanes exceed the "
            f"single-program lane cap ({esc._ESC_LANE_CAP}) and the "
            f"dimensions {A.shape} x {B.shape} exceed the CSR "
            f"delegation cap; split the product")
    oi, oj, ov = _hyper_esc_core(sr, A, B, mask, complement, structural,
                                 lens, kc, flops)
    record_axb_method("esc:hyper_spgemm")
    return _assemble(oi, oj, ov, m, n, zt)


# ---------------------------------------------------------------------------
# eWise add/mult: tagged pair-key merge
# ---------------------------------------------------------------------------

def hyper_ewise(op: BinaryOp, A: HyperMatrix, B: HyperMatrix,
                union: bool, ztype: Optional[Type] = None) -> HyperMatrix:
    """C = A (+|.*) B: the set-union (eWiseAdd, ``GB_add.c``) or
    set-intersection (eWiseMult, ``GB_emult.c``) pair-key merge.  Both
    sides' live lanes sort together, A's first on a shared pair; a pair
    present twice takes the op, a one-sided entry is cast straight to
    ztype (union only)."""
    from ..core.errors import DimensionMismatch
    if A.shape != B.shape:
        raise DimensionMismatch(f"{A.shape} vs {B.shape}")
    zt = ztype or op.ztype
    dev = A.device
    na, nb = A.nvals, B.nvals
    ci = torch.cat([A.rowids[:na], B.rowids[:nb]])
    cj = torch.cat([A.indices[:na], B.indices[:nb]])
    # each side's values travel in its own lane array (zeros on the
    # other side's lanes, never read there)
    va = tree_map(lambda v: torch.cat([v[:na], torch.zeros(
        nb, dtype=v.dtype, device=dev)]), A.values)
    vb = tree_map(lambda v: torch.cat([torch.zeros(
        na, dtype=v.dtype, device=dev), v[:nb]]), B.values)
    perm = _pair_argsort(ci, cj)   # stable: A lanes first on equal pairs
    si, sj = ci[perm], cj[perm]
    tg = perm >= na                # a B lane
    vas, vbs = value_take(va, perm), value_take(vb, perm)
    E = si.shape[0]
    head = _pair_heads(si, sj)
    nxt_same = torch.zeros(E, dtype=torch.bool, device=dev)
    nxt_same[:-1] = ~head[1:]
    is_pair = head & nxt_same
    vb_next = tree_map(lambda v: torch.roll(v, -1), vbs)
    z_pair = cast(cast_result(op(cast(vas, op.xtype, A.type),
                                 cast(vb_next, op.ytype, B.type)),
                              op.ztype), zt, op.ztype)
    out_v = tree_where(is_pair, z_pair,
                       tree_where(tg, cast(vbs, zt, B.type),
                                  cast(vas, zt, A.type)))
    keep = head if union else is_pair
    return _assemble(si[keep], sj[keep], value_take(out_v, keep), A.nrows,
                     A.ncols, zt)


# ---------------------------------------------------------------------------
# SpMV with a sparse vector: y<ids ⊆ A.h> = A *.sr* x
# ---------------------------------------------------------------------------

def hyper_mxv(sr: Semiring, A: HyperMatrix, x_ids, x_vals
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(y_ids, y_vals) = A *.sr* x for a sparse x given as sorted int64
    ids and host values of the semiring's y type (or storage).  Output
    ids ⊆ A.h: O(nvec), never O(dimension).  Returns host arrays."""
    dev = A.device
    xi = torch.from_numpy(np.asarray(x_ids, np.int64)).to(dev)
    xv = np.asarray(x_vals)
    xt = type_of_dtype(xv.dtype)
    xd = torch.from_numpy(np.array(xt.to_storage(xv))).to(dev)
    zt = sr.ztype
    ident = sr.add.identity_value()
    hcap = A.h.shape[0]
    if xi.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, zt.dtype)
    pos = torch.searchsorted(xi, A.indices)
    posc = pos.clamp(max=xi.shape[0] - 1)
    present = (xi[posc] == A.indices) & _live(A)
    z = cast_result(sr.mult(cast(A.values, sr.xtype, A.type),
                            cast(xd[posc], sr.ytype, xt)), zt)
    z = torch.where(present, z, torch.full((), ident, dtype=zt.storage,
                                           device=dev))
    # reduce into present-row segments: a live row id is in h, so its
    # searchsorted rank is exact
    seg = torch.searchsorted(A.h, A.rowids).clamp(max=hcap)
    y = segment_reduce(sr.add.op.name, z, seg, hcap + 1, ident, zt)[:hcap]
    hits = torch.zeros(hcap + 1, dtype=torch.int32, device=dev)
    hits.index_add_(0, seg, present.to(torch.int32))
    ylive = hits[:hcap] > 0
    return A.h[ylive].cpu().numpy(), host_values(y[ylive], zt)


# ---------------------------------------------------------------------------
# reduce / apply / select / transpose
# ---------------------------------------------------------------------------

def hyper_reduce_scalar(monoid: Monoid, A: HyperMatrix):
    """Fold all stored values with the monoid (``GB_reduce_to_scalar``);
    a numpy scalar of the monoid's type."""
    t = monoid.type
    z = tree_where(_live(A), cast(A.values, t, A.type),
                   monoid.identity_array((), A.device))
    red = segment_fold(monoid, z, torch.zeros(A.nzmax, dtype=torch.int64,
                                              device=A.device), 1, t)
    return tree_map(lambda a: a[0], host_values(red, t))


def hyper_reduce_vector(monoid: Monoid, A: HyperMatrix
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, vals): the per-row monoid fold, a sparse vector over A.h
    (host arrays)."""
    t = monoid.type
    hcap = A.h.shape[0]
    z = tree_where(_live(A), cast(A.values, t, A.type),
                   monoid.identity_array((), A.device))
    seg = torch.searchsorted(A.h, A.rowids).clamp(max=hcap)
    y = segment_fold(monoid, z, seg, hcap + 1, t)
    return (A.h[:A.nvec].cpu().numpy(),
            host_values(value_take(y, slice(0, A.nvec)), t))


def hyper_apply(op, A: HyperMatrix, ztype: Optional[Type] = None
                ) -> HyperMatrix:
    """C = op(A): a value-only map, the pattern shared (``GB_apply.c``
    via the shallow-pattern shortcut ``GB_shallow_op.c``)."""
    zt = ztype or op.ztype
    vals = cast_result(op(cast(A.values, op.xtype, A.type)), op.ztype)
    vals = cast(vals, zt, op.ztype)
    vals = tree_where(_live(A), vals, zeros_like_typed((), zt, A.device))
    return HyperMatrix(A.h, A.hptr, A.rowids, A.indices, vals, A.nvals,
                       A.nvec, A.nrows, A.ncols, zt)


def _filter(A: HyperMatrix, keep: torch.Tensor) -> HyperMatrix:
    """The live lanes of A where ``keep`` (over the live lanes) holds,
    in their order: a filter of a sorted list needs no re-sort."""
    n = A.nvals
    return _assemble(A.rowids[:n][keep], A.indices[:n][keep],
                     tree_map(lambda v: v[:n][keep], A.values),
                     A.nrows, A.ncols, A.type)


def hyper_select(name: str, A: HyperMatrix, k: int = 0,
                 user_fn=None) -> HyperMatrix:
    """C = select(A, k): TRIL/TRIU/DIAG/OFFDIAG/NONZERO or a user
    predicate fn(i, j, x) -> bool (``GxB_select`` / ``GB_select.c``);
    the predicate sees the live lanes only."""
    nm = name.upper()
    n = A.nvals
    i, j = A.rowids[:n], A.indices[:n]
    x = value_take(A.values, slice(0, n))
    if nm == "TRIL":
        keep = (j - i) <= k
    elif nm == "TRIU":
        keep = (j - i) >= k
    elif nm == "DIAG":
        keep = (j - i) == k
    elif nm == "OFFDIAG":
        keep = (j - i) != k
    elif nm == "NONZERO":
        keep = x != 0
    elif nm == "USER":
        keep = user_fn(i, j, x)
    else:
        raise NotImplementedError(f"select op {nm}")
    keep = torch.as_tensor(keep, dtype=torch.bool, device=A.device)
    return _filter(A, keep.expand(n))


def hyper_transpose(A: HyperMatrix) -> HyperMatrix:
    """C = A': the pairs swapped and re-sorted on the device (the bucket
    transpose of ``GB_transpose_bucket.c`` is a counting sort too)."""
    A = A.wait()
    n = A.nvals
    return _sorted_assemble(A.indices[:n], A.rowids[:n],
                            value_take(A.values, slice(0, n)),
                            A.ncols, A.nrows, A.type)


# ---------------------------------------------------------------------------
# accum/mask epilogue: C<M> = accum(C, T)  (GB_accum_mask / GB_spec_mask)
# ---------------------------------------------------------------------------

def _truthy_lanes(M: HyperMatrix, structural: bool) -> torch.Tensor:
    live = _live(M)
    if not structural:
        if M.type.is_udt:
            raise TypeError("a mask with user-defined values is not valid; "
                            "use a structural mask")
        live = live & (M.values != 0)
    return live


def hyper_accum_mask(C: HyperMatrix, M: Optional[HyperMatrix],
                     T: HyperMatrix, accum: Optional[BinaryOp],
                     replace: bool = False, complement: bool = False,
                     structural: bool = False) -> HyperMatrix:
    """The canonical epilogue on hypersparse operands: Z = accum ?
    eWiseAdd(C, T, accum) : T, then the mask merge: entries where the
    (effective) mask is true come from Z, elsewhere from C (dropped
    under REPLACE).  Transcribes ``GB_spec_mask.m`` / ``GB_mask.c``;
    the two kept lane sets are disjoint, so one pair sort on the device
    assembles them."""
    C = C.wait()  # fold pending deltas (GB_WAIT at op entry)
    if M is not None:
        M = M.wait()
    Z = hyper_ewise(accum, C, T, union=True, ztype=C.type) \
        if accum is not None else T
    if M is None:
        if complement:
            # effective mask all-false: Z invisible; REPLACE clears C
            return _empty_hyper(C.nrows, C.ncols, C.type, C.device) \
                if replace else C
        return Z
    m_live = _truthy_lanes(M, structural)
    z_in = _pair_member(Z.rowids[:Z.nvals], Z.indices[:Z.nvals],
                        M.rowids, M.indices, m_live)
    c_in = _pair_member(C.rowids[:C.nvals], C.indices[:C.nvals],
                        M.rowids, M.indices, m_live)
    if complement:
        z_in, c_in = ~z_in, ~c_in
    keep_c = ~c_in & (not replace)
    zv = cast(tree_map(lambda v: v[:Z.nvals][z_in], Z.values), C.type,
              Z.type)
    I = torch.cat([Z.rowids[:Z.nvals][z_in], C.rowids[:C.nvals][keep_c]])
    J = torch.cat([Z.indices[:Z.nvals][z_in],
                   C.indices[:C.nvals][keep_c]])
    X = tree_map(lambda z, c: torch.cat([z, c[:C.nvals][keep_c]]), zv,
                 C.values)
    return _sorted_assemble(I, J, X, C.nrows, C.ncols, C.type)


def cast_host(x, t: Type) -> np.ndarray:
    """Host values (a numpy array of a builtin dtype) cast to ``t``'s
    numpy dtype with the port's C-style rules."""
    x = np.asarray(x)
    if not len(x):
        return x.astype(t.dtype)
    src = type_of_dtype(x.dtype)
    y = cast(torch.from_numpy(np.array(src.to_storage(x))), t, src)
    return host_values(y, t)


# ---------------------------------------------------------------------------
# hypersparsity conformance (GB_to_hyper_conform)
# ---------------------------------------------------------------------------

#: reference sentinels (``Include/GraphBLAS.h`` GxB_HYPER): a ratio of
#: ALWAYS forces hypersparse, NEVER (any negative) forces standard CSR
GxB_HYPER_DEFAULT = 1.0 / 16
GxB_ALWAYS_HYPER = 1e100
GxB_NEVER_HYPER = -1.0


def nvec_nonempty(A) -> int:
    """Number of non-empty vectors (the reference caches it on the
    matrix, ``GB_matrix.h:345``): one device count on CSR, free on
    hypersparse."""
    if isinstance(A, HyperMatrix):
        return A.nvec
    d = A.indptr[1:] - A.indptr[:-1]
    return int(torch.count_nonzero(d))


def _public_options(A) -> dict:
    """A container's settable options (``hyper_ratio``, ``format``),
    without the host pattern and plan caches tied to its tensors."""
    from ..core.options import public_options
    return public_options(A._options)


def _ratio_of(A, ratio):
    if ratio is not None:
        return float(ratio)
    r = A._options.get("hyper_ratio")
    if r is None:
        from ..core.options import get_option
        r = get_option("hyper_ratio")
    return float(r)


def hyper_conform(A, ratio: Optional[float] = None):
    """Convert between CSR and hypersparse by the reference's hysteresis
    rule (``GB_matrix.h:216-246``): a CsrMatrix becomes hypersparse when
    ``nvec_nonempty <= nrows * ratio``, a HyperMatrix becomes CSR when
    ``nvec > 2 * nrows * ratio``; in between the format is kept.
    ``ratio`` defaults to the matrix's ``hyper_ratio`` option, then the
    global one (``GxB_HYPER``); the ALWAYS/NEVER sentinels short-circuit.
    Containers are immutable, so conformance returns a new object and
    runs at container boundaries (import/export, and wherever the caller
    asks).  A dimension too large for an O(nrows) indptr stays
    hypersparse whatever the ratio."""
    r = _ratio_of(A, ratio)
    if isinstance(A, HyperMatrix):
        if A.nrows > (1 << 28):       # indptr would not fit: stay hyper
            return A
        if r >= 1e99:                 # ALWAYS_HYPER
            return A
        if r < 0 or A.nvec > 2.0 * A.nrows * r:
            out = A.to_csr()
            out._options.update(_public_options(A))
            return out
        return A
    # CsrMatrix side
    if r < 0:                         # NEVER_HYPER
        return A
    if r >= 1e99 or nvec_nonempty(A) <= A.nrows * r:
        out = HyperMatrix.from_csr(A)
        out._options.update(_public_options(A))
        return out
    return A
