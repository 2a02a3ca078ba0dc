"""Elementwise ops on the padded-CSR container: union/intersection
merges, apply, select and reduction, without densifying.

Counterpart of ``graphblas_tpu/sparse/ewise.py``.  Reference:
``GB_add.c`` (4-case union merge), ``GB_emult.c`` (intersection),
``GB_apply_op.c``, ``GB_select.c``, ``GB_reduce_to_scalar/column``.
Both the symbolic phase (where each entry lands) and the numeric phase
(the op) run on the operands' device: the union is a rank-by-
``searchsorted`` merge of the two sorted linear key lists (the two-way
form of the reference's per-vector 4-case walk), the intersection one
binary-search probe of B for every A lane.  Only the output's entry
count crosses to the host (the container keeps ``nvals`` there).

Typecasts follow the reference (``GB_add.c:9-55``): entries in the
intersection are cast into the op's x/y domains and the result into
ztype; an entry present on one side only is cast from its stored type
straight to ztype, with no op applied (so ``eWiseAdd(minus)`` keeps a
B-only entry as b, not -b).

The union's output capacity is trimmed to its exact entry count (at
least the 8 lanes of an empty container); the JAX package rounds it up
to a power-of-two bucket to bound its recompiles, which torch has no
need of.

Float MIN/MAX row reductions give the bitmap reduce's answer: a NaN
term is ignored (``segment_reduce`` folds from the identity), and a row
whose every column holds NaN reduces to NaN, as numpy's ``nanmin``
does over the bitmap row.  The JAX package's CSR row reduce propagates
every NaN instead (ROADMAP.md queue 3, "known in the reference").

Values of a user-defined type ride every merge field by field (the
struct-of-arrays form); their ops get and give dicts, and a user-
defined monoid reduces rows by the generic segmented fold (the JAX
package's CSR row reduce raises for it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.monoids import Monoid
from ..core.ops import BinaryOp, SelectOp, UnaryOp
from ..core.types import (Type, cast, cast_result, tree_where,
                          value_take, zeros_like_typed)
from ..utils.counters import host_read
from ..utils.tree import tree_map
from .container import CsrMatrix
from .spmv import segment_fold
from .tri import csr_filter_lanes

__all__ = ["csr_ewise_add", "csr_ewise_mult", "csr_apply", "csr_select",
           "csr_reduce_rows", "csr_reduce_scalar", "host_scalar",
           "host_value"]

_BIG = torch.iinfo(torch.int64).max


def _live(A: CsrMatrix) -> torch.Tensor:
    return torch.arange(A.nzmax, device=A.device) < A.nvals


def _keys(A: CsrMatrix) -> torch.Tensor:
    """Sorted int64 linear keys of the padded entry list (dead lanes
    hold int64 max)."""
    k = A.rowids.long() * A.ncols + A.indices.long()
    return torch.where(_live(A), k, _BIG)


def _scatter(n: int, idx: torch.Tensor, v: torch.Tensor, fill=0):
    out = torch.full((n,), fill, dtype=v.dtype, device=v.device)
    return out.scatter_(0, idx, v)


def _union(op: BinaryOp, zt: Type, nrows: int, ncols: int, ka, kb,
           xa, xb, za, zb, nA: int):
    """Union merge C = A ∪ B with op on the intersection.

    ``xa``/``xb`` are the operands cast into the op's x/y domains (read
    on paired keys), ``za``/``zb`` the ztype casts (read on singletons).
    Each A lane ranks at ``searchsorted(kb, ka, 'left')`` and each B
    lane at ``searchsorted(ka, kb, 'right')``, so a shared key lands
    twice side by side, A's copy first; adjacent duplicates fold with
    ``op`` and the first lanes compact by a cumulative sum."""
    dev = ka.device
    EA, EB = ka.shape[0], kb.shape[0]
    EC = EA + EB
    out_a = torch.arange(EA, device=dev) + torch.searchsorted(
        kb, ka, side="left")
    out_b = torch.arange(EB, device=dev) + torch.searchsorted(
        ka, kb, side="right")
    mk = _scatter(EC, out_a, ka, _BIG).scatter_(0, out_b, kb)
    va_x = tree_map(lambda v: _scatter(EC, out_a, v), xa)
    vb_y = tree_map(lambda v: _scatter(EC, out_b, v), xb)
    va_z = tree_map(lambda v: _scatter(EC, out_a, v), za)
    vb_z = tree_map(lambda v: _scatter(EC, out_b, v), zb)
    isa = _scatter(EC, out_a, torch.arange(EA, device=dev) < nA, False)
    live = mk < _BIG
    dup = torch.zeros(EC, dtype=torch.bool, device=dev)
    dup[1:] = live[1:] & (mk[1:] == mk[:-1])
    first = live & ~dup
    pair = first & torch.cat([dup[1:], dup.new_zeros(1)])
    zboth = cast_result(op(va_x, tree_map(lambda v: torch.roll(v, -1),
                                          vb_y)), zt)
    z = tree_where(pair, zboth, tree_where(isa, va_z, vb_z))
    # compact the first lanes in key order
    nv = int(first.sum())
    cap = max(nv, 8)
    sink = max(EC, cap)              # the slot the other lanes write
    tgt = torch.where(first, torch.cumsum(first, 0) - 1, sink)
    okeys = _scatter(sink + 1, tgt, mk, _BIG)[:cap]
    ovals = tree_map(lambda v: _scatter(sink + 1, tgt, v)[:cap], z)
    olive = okeys < _BIG
    oI = torch.where(olive, okeys // ncols, nrows).to(torch.int32)
    oJ = torch.where(olive, okeys % ncols, ncols).to(torch.int32)
    counts = torch.bincount(oI[:nv].long(), minlength=nrows)
    indptr = torch.zeros(nrows + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, oJ, oI, ovals, nv


def csr_ewise_add(op: BinaryOp, A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """C = A ∪ B with op on the intersection (``GrB_eWiseAdd``)."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    zt = op.ztype
    indptr, oJ, oI, ovals, nv = _union(
        op, zt, A.nrows, A.ncols, _keys(A), _keys(B),
        cast(A.values, op.xtype, A.type), cast(B.values, op.ytype, B.type),
        cast(A.values, zt, A.type), cast(B.values, zt, B.type), A.nvals)
    return CsrMatrix(indptr, oJ, oI, ovals, nv, A.nrows, A.ncols, zt)


def csr_ewise_mult(op: BinaryOp, A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """C = A ∩ B with op (``GrB_eWiseMult``): each A lane probes B's
    sorted keys once, then the matches compact."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    zt = op.ztype
    ka, kb = _keys(A), _keys(B)
    xa = cast(A.values, op.xtype, A.type)
    xb = cast(B.values, op.ytype, B.type)
    posc = torch.searchsorted(kb, ka).clamp(max=kb.shape[0] - 1)
    match = (kb[posc] == ka) & (ka < _BIG)
    z = cast_result(op(xa, value_take(xb, posc)), zt)
    z = tree_where(match, z, zeros_like_typed((), zt, A.device))
    tmp = CsrMatrix(A.indptr, A.indices, A.rowids, z, A.nvals, A.nrows,
                    A.ncols, zt)
    return csr_filter_lanes(tmp, match)


def csr_apply(op: UnaryOp, A: CsrMatrix) -> CsrMatrix:
    """C = op(A): the pattern shared, one pass over the padded values
    (the ``GB_shallow_op`` trick: the structure arrays are reused)."""
    zt = op.ztype
    vals = cast_result(op(cast(A.values, op.xtype, A.type)), zt)
    vals = tree_where(_live(A), vals, zeros_like_typed((), zt, A.device))
    return CsrMatrix(A.indptr, A.indices, A.rowids, vals, A.nvals,
                     A.nrows, A.ncols, zt)


def csr_select(op: SelectOp, A: CsrMatrix, thunk=0) -> CsrMatrix:
    """C = select(A, thunk): one predicate over the padded entry list,
    then a device compaction (``GxB_select`` / GB_select.c)."""
    keep = op(A.rowids, A.indices, A.values, thunk)
    return csr_filter_lanes(A, torch.as_tensor(keep, dtype=torch.bool,
                                               device=A.device))


def csr_reduce_rows(mon: Monoid, A: CsrMatrix):
    """(values, pattern) of the per-row monoid reduction
    (``GB_reduce_to_column``): one segment reduce on the device."""
    t = mon.type
    dev = A.device
    live = _live(A)
    vals = cast(A.values, t, A.type)
    vals = tree_where(live, vals, mon.identity_array((), dev))
    rows = A.rowids.long().clamp(max=A.nrows)
    red = tree_map(lambda v: v[:A.nrows],
                   segment_fold(mon, vals, rows, A.nrows + 1))
    deg = A.indptr[1:] - A.indptr[:-1]
    if t.is_float and mon.op.name in ("MIN", "MAX"):
        # a full row of NaN is NaN, as the bitmap reduce's nanmin gives
        nans = torch.zeros(A.nrows + 1, dtype=torch.int64, device=dev)
        nans.index_add_(0, rows, (torch.isnan(vals) & live).long())
        red = torch.where((nans[:A.nrows] == A.ncols) & (deg == A.ncols),
                          torch.nan, red)
    return red, deg > 0


def host_scalar(r, t: Type, flag: torch.Tensor = None):
    """A one-element tensor of ``t``'s storage as a numpy scalar of the
    type's own dtype (a dict of them for a user-defined type), each read
    through ``host_read`` (site ``reduce_scalar``).  With ``flag``, a
    one-element bool tensor of a builtin ``t``'s device, the same copy
    reads it too: (the scalar, ``bool(flag)``)."""
    if t.is_udt:
        return {k: host_scalar(r[k], ft) for k, ft in t.fields}
    x = r.reshape(1)
    if flag is None:
        return host_value(host_read(x, "reduce_scalar", np.ndarray), t)
    b = host_read(torch.cat([x.view(torch.uint8),
                             flag.reshape(1).view(torch.uint8)]),
                  "reduce_scalar", np.ndarray)
    a = torch.from_numpy(b[:-1].copy()).view(x.dtype).numpy()
    return host_value(a, t), bool(b[-1])


def host_value(a: np.ndarray, t: Type):
    """The first element of a host array of ``t``'s storage as a numpy
    scalar of the type's own dtype (a UINT64 value read as
    unsigned)."""
    if t.is_unsigned:
        a = a.view(t.dtype)
    return a[0]


def csr_reduce_scalar(mon: Monoid, A: CsrMatrix):
    """Full reduction to a host scalar (``GB_reduce_to_scalar``): dead
    lanes contribute the identity; only the final scalar crosses to the
    host, as a numpy scalar of the monoid's type."""
    if A.nvals == 0:
        return mon.identity
    vals = cast(A.values, mon.type, A.type)
    return host_scalar(mon.reduce(vals, where=_live(A)), mon.type)

