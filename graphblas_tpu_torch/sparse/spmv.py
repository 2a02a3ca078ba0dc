"""Sparse matrix-vector multiply over semirings: gather + segment-reduce.

Counterpart of ``graphblas_tpu/sparse/spmv.py``.  The reference's SpMV
is a CSR row walk inside the generated semiring workers; here it is
edge-parallel: one gather of x at the column indices, one vectorized
multiply, one reduction per row.  Padded lanes read the identity slot
appended to x (the containers' sentinel convention).

Engines, as the JAX package chooses them in :func:`csr_mxv`:

* dense and finite x, f32 ``plus_times`` and tiles dense enough
  (:func:`cuda_spmv.bsr_spmv_ok`): the BSR tile kernel (K5);
* dense x otherwise: :func:`_csr_mxv_dense_x` (rows reduced by the
  named segment reductions or the segmented fold, the pattern from the
  row degrees);
* sparse x: :func:`_csr_mxv_sparse_x` (absent-x and padded lanes take
  the add identity; the pattern is the rows with a live lane).

Two TPU workarounds of the JAX package are left out, since both exist
only because per-lane gathers and segment sums were slow on the TPU:
the sort-routed dense-x engine (``spmv_plan``, ``_csr_mxv_sorted_jit``;
where the JAX package takes it the port takes the dense-x engine) and
the dense-x engine's row sums by a global widened cumulative sum, whose
rounding is relative to the whole prefix (one non-finite lane poisons
every later row, a large prefix cancels a small row).  The port's row
sums are row-local, as the JAX package's sparse-x engine's are: the
output is the same (integers and booleans exactly, floats within
reassociation).

Segment reductions (the ``GB_assoc_template.c`` switch-factory
analogue): named monoids scatter into an identity-filled output: PLUS
and TIMES (integers in int64, wrapped back to the storage width:
congruent), MIN and MAX over the type's own order (unsigned read as
unsigned; float NaN terms replaced by the identity, so a NaN drops out
as in the bitmap path), LOR/LAND as any/all, LXOR/EQ as parity counts.  An empty
segment holds the identity.

LOR and LAND fold by the op itself on every type, as the reference
defines it (``LOR(x, y) = (x != 0) || (y != 0)``): a segment holds 1
where any term (LOR) or every term (LAND) is nonzero and 0 otherwise,
in the monoid's type, from the identity.  The JAX package folds them
over non-bool types by a max/min of the values instead (ROADMAP.md
queue 3, "known in the reference").  Any other monoid takes the generic
segmented fold.

Complex values: PLUS sums the real and imaginary parts apart
(``index_add_`` over the real view), MIN/MAX take the lexicographic
extreme from the identity with NaN terms dropped (two ``scatter_reduce``
passes in :func:`ops.cx_extreme`, which the bitmap monoid reduce
shares: the real part, then the imaginary part among the terms that
hold it), and TIMES, which ``scatter_reduce`` lacks for complex, takes
the generic fold.

A user-defined semiring runs the edge-parallel engine of the JAX
package's UDT path (``_udt_mxv_prog``) through the sparse-x engine: no
casting, the operands already in the semiring's domains, the rows
folded by the generic segmented fold over the struct's leaves, rows
with no live lane holding the identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.ops import cx_extreme
from ..core.semirings import Semiring
from ..core.types import (Type, cast, from_ordered, ordered, tree_where,
                          type_of_dtype, type_of_storage, value_take)
from ..utils import counters
from ..utils.counters import host_read
from ..utils.tree import tree_map
from ..ops.flopcount import record_axb_method
from . import cuda_spmv
from .container import CsrMatrix

__all__ = ["csr_mxv", "csr_vxm", "segment_reduce", "segment_reduce_sorted",
           "segment_fold"]

#: monoids with a named segment reduction
_NAMED = ("PLUS", "TIMES", "MIN", "MAX", "LOR", "LAND", "LXOR", "EQ")


def segment_reduce_sorted(op_fn, identity, vals: torch.Tensor,
                          seg_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Segment reduction for ANY associative op when ``seg_ids`` is
    sorted ascending (CSR entry order guarantees it): a log-depth
    segmented inclusive scan (each step folds the lane ``d`` places back
    into a lane of the same segment), then each segment's last lane.
    Segments with no lanes hold ``identity`` (a storage scalar; a dict
    of them for struct values, whose leaves fold alike)."""
    E = seg_ids.shape[0]
    dev = seg_ids.device
    x = vals
    d = 1
    while d < E:
        same = seg_ids[d:] == seg_ids[:-d]
        lo = tree_map(lambda v: v[:-d], x)
        hi = tree_map(lambda v: v[d:], x)
        folded = tree_where(same, op_fn(lo, hi), hi)
        x = tree_map(lambda v, f: torch.cat([v[:d], f.to(v.dtype)]), x,
                     folded)
        d <<= 1
    if E:
        is_last = torch.cat([seg_ids[1:] != seg_ids[:-1],
                             torch.ones(1, dtype=torch.bool, device=dev)])
        tgt = torch.where(is_last, seg_ids.long(), num_segments)
        tgt = tgt.clamp(max=num_segments)

    def land(v, ident):
        out = torch.full((num_segments + 1,), ident, dtype=v.dtype,
                         device=dev)
        if E:
            out.scatter_(0, tgt, v)
        return out[:num_segments]
    return tree_map(land, x, identity)


def segment_fold(mon, vals, seg_ids: torch.Tensor, num_segments: int,
                 t: Type = None):
    """Fold ``vals`` (in ``mon``'s type) into ``num_segments`` slots with
    the monoid ``mon``: a named segment reduction where one exists, the
    generic segmented fold otherwise (user-defined types, other ops, and
    complex TIMES).  ``seg_ids`` must be sorted ascending for the
    generic fold."""
    t = t or mon.type
    name = mon.op.name
    ident = mon.identity_value()
    if t.is_udt or name not in _NAMED or (t.is_complex and
                                          name == "TIMES"):
        return segment_reduce_sorted(mon.op, ident, vals, seg_ids,
                                     num_segments)
    return segment_reduce(name, vals, seg_ids, num_segments, ident, t)


def segment_reduce(monoid_name: str, vals: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int, identity,
                   t: Type = None) -> torch.Tensor:
    """Segment-reduce ``vals`` (storage of type ``t``; default: the type
    its dtype names) with a named monoid into ``num_segments`` slots;
    ``identity`` is the monoid's identity as a storage scalar."""
    nm = monoid_name.upper()
    t = t or type_of_storage(vals.dtype)
    dev = vals.device
    idx = seg_ids.long()
    if nm in ("LOR", "LAND") and vals.dtype != torch.bool:
        # the op's own fold from the identity, (x != 0) or/and ...: 1
        # where any (LOR) or every (LAND) term is nonzero, else 0, in
        # the type (an empty segment holds the identity, 0 / 1)
        return segment_reduce(nm, vals != 0, seg_ids, num_segments,
                              identity).to(vals.dtype)
    if vals.dtype == torch.bool:
        if nm in ("PLUS", "MAX", "LOR"):
            nm = "ANY"
        elif nm in ("TIMES", "MIN", "LAND"):
            nm = "ALL"
    if nm in ("ANY", "ALL"):
        v = vals if nm == "ANY" else ~vals
        hit = torch.zeros(num_segments, dtype=torch.int32, device=dev)
        hit.index_add_(0, idx, v.to(torch.int32))
        return hit > 0 if nm == "ANY" else hit == 0
    if t.is_complex and nm == "PLUS":
        out = torch.zeros((num_segments, 2), dtype=vals.real.dtype,
                          device=dev)
        out.index_add_(0, idx, torch.view_as_real(vals.contiguous()))
        return torch.view_as_complex(out)
    if t.is_complex and nm in ("MAX", "MIN"):
        return _cx_segment_minmax(nm, vals, idx, num_segments, identity)
    if nm in ("PLUS", "TIMES"):
        wide = vals.to(torch.int64) if t.is_integer else vals
        out = torch.full((num_segments,), 0 if nm == "PLUS" else 1,
                         dtype=wide.dtype, device=dev)
        if nm == "PLUS":
            out.index_add_(0, idx, wide)
        else:
            out.scatter_reduce_(0, idx, wide, reduce="prod")
        return out.to(vals.dtype)
    if nm in ("MAX", "MIN"):
        if vals.dtype.is_floating_point:
            # fmin/fmax from the identity, as the bitmap path, K6 and
            # SpMM fold: a NaN term drops out, an all-NaN segment holds
            # the identity (scatter_reduce's amin/amax propagate NaN)
            vals = torch.where(torch.isnan(vals), torch.full(
                (), identity, dtype=vals.dtype, device=dev), vals)
        keys = ordered(vals, t)
        # the identity filled on the device: a host tensor copied over
        # would be a pageable copy, which waits for the card
        ident = torch.full((), identity, dtype=vals.dtype, device=dev)
        out = ordered(ident, t).to(keys.dtype).expand(num_segments).clone()
        out.scatter_reduce_(0, idx, keys, reduce=(
            "amax" if nm == "MAX" else "amin"))
        return from_ordered(out, t)
    if nm in ("LXOR", "EQ"):
        cnt = torch.zeros(num_segments, dtype=torch.int32, device=dev)
        hit = (vals != 0) if nm == "LXOR" else (vals == 0)
        cnt.index_add_(0, idx, hit.to(torch.int32))
        par = cnt % 2 != 0 if nm == "LXOR" else cnt % 2 == 0
        return par.to(vals.dtype)
    raise NotImplementedError(f"segment monoid {nm}")


def _cx_segment_minmax(nm: str, vals: torch.Tensor, idx: torch.Tensor,
                       num_segments: int, identity) -> torch.Tensor:
    """Lexicographic complex MIN/MAX per segment from the identity, NaN
    terms dropped (:func:`ops.cx_extreme`, by ``scatter_reduce``)."""
    dev = vals.device
    ident = torch.full((), identity, dtype=vals.dtype, device=dev)

    def red(v, how):
        init = float("-inf") if how == "amax" else float("inf")
        out = torch.full((num_segments,), init, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, idx, v, reduce=how)
    return cx_extreme(vals, nm, ident, red, lambda r: r[idx])


def _mult_apply(sr: Semiring, avals: torch.Tensor,
                xvals: torch.Tensor) -> torch.Tensor:
    """z = mult(a, x) elementwise on the gathered lanes (operands in the
    semiring's domains)."""
    nm = sr.mult.name
    if nm in ("TIMES", "LAND") and avals.dtype == torch.bool:
        return avals & (xvals if xvals.dtype == torch.bool else xvals != 0)
    if nm == "FIRST":
        return avals
    if nm == "SECOND":
        return xvals
    if nm == "PAIR":
        return torch.ones_like(avals)
    return sr.mult(avals, xvals)


def _reduce_rows(sr: Semiring, z, seg: torch.Tensor, nrows: int):
    """Row reduction of the lanes ``z`` (rows ``seg``, ascending; padded
    lanes in row ``nrows``) with the add monoid: the named segment
    reduction, or the segmented fold for any other monoid."""
    return tree_map(lambda v: v[:nrows],
                    segment_fold(sr.add, z, seg, nrows + 1, sr.ztype))


def _off_pattern_zero(y: torch.Tensor, ypat: torch.Tensor) -> torch.Tensor:
    return torch.where(ypat, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def _csr_mxv_sparse_x(sr: Semiring, A: CsrMatrix, avals, x_ext, xp_ext,
                      udt: bool = False):
    """Sparse-x engine: absent-x and padded lanes contribute the add
    identity (which keeps it right for every semiring, not only those
    where mult(a, 0) is the identity); the pattern is the rows with at
    least one live lane.  Off the pattern a row holds 0; under a
    user-defined semiring (``udt``: operands that may be struct trees,
    no cast) it holds the identity, as the JAX package's
    ``_udt_mxv_prog``."""
    nrows = A.nrows
    zt = sr.ztype
    cols = A.indices
    ident = sr.add.identity_array((), A.device)
    if udt:
        z = sr.mult(avals, value_take(x_ext, cols))
    else:
        z = _mult_apply(sr, avals, x_ext[cols]).to(zt.storage)
    # a padded lane lands in row nrows, which no output keeps
    live = xp_ext[cols]
    z = tree_where(live, z, ident)
    seg = A.rowids.clamp(max=nrows).long()
    y = _reduce_rows(sr, z, seg, nrows)
    hits = torch.zeros(nrows + 1, dtype=torch.int32, device=A.device)
    hits.index_add_(0, seg, live.to(torch.int32))
    ypat = hits[:nrows] > 0
    record_axb_method("spmv:udt" if udt else "spmv:sparse_x")
    if udt:
        return tree_where(ypat, y, ident), ypat
    if sr.add.identity_value() == 0:
        # a row with no live lane folded only identities: it holds 0
        return y, ypat
    return _off_pattern_zero(y, ypat), ypat


def _csr_mxv_dense_x(sr: Semiring, A: CsrMatrix, avals: torch.Tensor,
                     x_ext: torch.Tensor):
    """Dense-x engine: one gather of x, the rows reduced by the named
    segment reductions or the segmented fold; the pattern from the row
    degrees."""
    nrows = A.nrows
    zt = sr.ztype
    ident = sr.add.identity_value()
    z = _mult_apply(sr, avals, x_ext[A.indices.long()]).to(zt.storage)
    z = torch.where(A.rowids < nrows, z,
                    torch.full((), ident, dtype=zt.storage, device=z.device))
    ip = A.indptr.long()
    ypat = ip[1:] > ip[:-1]
    y = _reduce_rows(sr, z, A.rowids.clamp(max=nrows), nrows)
    record_axb_method("spmv:dense_x")
    return _off_pattern_zero(y, ypat), ypat


def _as_storage(x, x_type: Optional[Type], device) -> tuple:
    """(tensor on ``device``, its Type) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device), x_type or type_of_storage(x.dtype)
    a = np.asarray(x)
    t = x_type or type_of_dtype(a.dtype)
    return torch.from_numpy(np.array(t.to_storage(a))).to(device), t


@counters.spanned("gb.engines.spmv")
def csr_mxv(sr: Semiring, A: CsrMatrix, x, x_pattern=None,
            x_type: Optional[Type] = None):
    """(yvals, ypat) = A *.sr* x.  ``x``: dense [ncols] values (numpy or
    a tensor; ``x_type`` names its type, default the one its dtype
    names); ``x_pattern`` marks the present entries (None = all
    present).  Operands are cast into the semiring's domains first.

    Dense-x f32 PLUS_TIMES takes the BSR tile kernel only when every x
    entry is finite: its dense tiles would give 0*inf = NaN in every row
    sharing a column block with an inf/NaN entry.  (The JAX package's
    ``csr_mxv`` takes the tiles regardless; ``A._options['bsr_spmv'] =
    False`` opts a matrix out.)  The engines run in the span
    ``gb.engines.spmv``; the finiteness test is a read
    (``gb.read.finite_x``)."""
    dev = A.device
    if any(t.is_udt for t in (sr.ztype, sr.xtype, sr.ytype, A.type)):
        return _csr_mxv_udt(sr, A, x, x_pattern)
    x, xt = _as_storage(x, x_type, dev)
    x = cast(x, sr.ytype, xt)
    if (x_pattern is None and cuda_spmv.bsr_spmv_ok(sr, A)
            and host_read(torch.isfinite(x).all(), "finite_x", bool)):
        # dense finite x, dense-enough tiles: the BSR tile kernel
        return cuda_spmv.bsr_spmv(sr, A, x)
    avals = cast(A.values, sr.xtype, A.type)
    # identity slot for padded column indices (sentinel = ncols)
    x_ext = F.pad(x, (0, 1))
    if x_pattern is None:
        return _csr_mxv_dense_x(sr, A, avals, x_ext)
    xp_ext = F.pad(torch.as_tensor(x_pattern).to(dev, torch.bool), (0, 1))
    return _csr_mxv_sparse_x(sr, A, avals, x_ext, xp_ext)


def _csr_mxv_udt(sr: Semiring, A: CsrMatrix, x, x_pattern):
    """The user-defined semiring's edge-parallel SpMV (the JAX package's
    ``_udt_mxv_prog``): no casting, every x present unless
    ``x_pattern`` says otherwise, then the sparse-x engine over the
    struct's leaves."""
    dev = A.device
    x = tree_map(lambda v: torch.as_tensor(v).to(dev), x)
    x_ext = tree_map(lambda v: torch.cat([v, torch.zeros(
        1, dtype=v.dtype, device=dev)]), x)
    if x_pattern is None:
        xp = torch.ones(A.ncols, dtype=torch.bool, device=dev)
    else:
        xp = torch.as_tensor(x_pattern).to(dev, torch.bool)
    xp_ext = torch.cat([xp, torch.zeros(1, dtype=torch.bool, device=dev)])
    return _csr_mxv_sparse_x(sr, A, A.values, x_ext, xp_ext, udt=True)


def csr_vxm(sr: Semiring, x, AT: CsrMatrix, x_pattern=None,
            x_type: Optional[Type] = None):
    """w = x' *.sr* A given AT = A' in CSR (i.e. A in CSC): the same
    edge-parallel engines; the caller caches the transpose."""
    return csr_mxv(sr, AT, x, x_pattern, x_type)
