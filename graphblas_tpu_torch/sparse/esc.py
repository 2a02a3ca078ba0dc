"""General sparse SpGEMM with sparse output: the ESC engine.

Counterpart of ``graphblas_tpu/sparse/esc.py``: C<M> = A *.semiring* B
for CSR inputs producing CSR output at O(flops) memory, for ANY (add
monoid, mult op) pair, with a fused mask and no densification.  The
expand-sort-compress formulation of the reference's Gustavson engine
(``Source/GB_AxB_Gustavson.c:139-160``):

  1. *expand*: every multiply the product needs, ``z_t = a_e * b_pos``,
     is one lane; lane t's A entry comes from a ``repeat_interleave`` of
     the per-entry B-row degrees (the flop enumeration of
     ``GB_AxB_flopcount.c``), its B entry by offset into B's row;
  2. *sort*: lanes are keyed by output coordinate i*n+j and sorted
     (stable).  The mask is applied before the sort: a CSR stores its
     keys ascending, so a lane's membership is a binary search in the
     mask's keys as stored, and a lane outside the effective mask takes
     a key past every output coordinate and falls to the tail.  No mask
     key enters the sort (the JAX package merges the mask's sorted keys
     into it and takes a running maximum, ``lax.cummax``);
  3. *compress*: segment heads mark unique output coordinates; the add
     monoid folds each segment (named monoids scatter-reduce; any other
     associative op takes a segmented scan), and head lanes compact to
     the padded output.  A masked-out lane is a segment of its own, so
     the fold puts no two of them on one slot.

Capacity planning reads two scalars on a cold call (the flop total, the
sum of :func:`~graphblas_tpu_torch.ops.flopcount.entry_lanes`, and the
output nnz); both are kept in a per-(A, B, mask) plan cache with the
expansion carries, so warm calls read nothing back.

Values of a user-defined type ride the engine field by field: every
leaf is gathered by the same lanes and permuted by the same stable key
sort (the JAX package sorts the leaves as extra sort operands, in the
sorted-key order of :mod:`graphblas_tpu_torch.utils.tree`), the add
monoid folds each segment by the generic segmented scan over the
struct, and a mask with struct values raises (only a structural mask is
valid over them).  Complex PLUS folds by parts, complex TIMES by the
generic fold.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..core.errors import DimensionMismatch
from ..core.semirings import Semiring
from ..core.types import (Type, cast, cast_result, tree_where, value_take,
                          zeros_like_typed)
from ..ops.flopcount import entry_lanes, flop_blocks, record_axb_method
from ..utils import counters, faultinject
from ..utils.counters import host_read
from ..utils.tree import tree_map
from .container import CsrMatrix
from .spmv import segment_fold

__all__ = ["csr_spgemm", "esc_combine", "_bucket"]

#: lanes per program: a memory bound (the expansion holds about a dozen
#: lane-sized arrays, ~100 B/lane); bigger products split into
#: flop-balanced A-entry blocks
_ESC_LANE_CAP = 1 << 24


def _bucket(x: int, lo: int = 128) -> int:
    """Round up to the next power of two (>= lo)."""
    c = lo
    while c < x:
        c <<= 1
    return c


def _bucket4(x: int, lo: int = 1024) -> int:
    """Quarter-step bucket: next value in {5/8, 6/8, 7/8, 8/8} * 2^k
    (>= lo, multiple of 128), as the JAX package sizes its lane arrays."""
    c = _bucket(x, lo)
    if c <= lo:
        return c
    for num in (5, 6, 7):
        v = (c // 8) * num
        if v >= x and v % 128 == 0:
            return v
    return c


def _mask_keys(M: CsrMatrix, n: int, kdt, structural: bool = False):
    """(keys, selects) of the mask in storage order.  A CSR stores its
    entries by row, then column, and pads with (nrows, ncols), so the
    keys ascend as stored and need no sort; a slot selects when it is
    live and, for a valued mask, nonzero."""
    sel = torch.arange(M.nzmax, device=M.device) < M.nvals
    if not structural:
        if M.type.is_udt:
            raise TypeError("a mask with user-defined values is not valid; "
                            "use a structural mask")
        sel = sel & (M.values != 0)
    return M.rowids.to(kdt) * n + M.indices.to(kdt), sel


def _in_mask(m_keys: torch.Tensor, m_sel: torch.Tensor,
             keys: torch.Tensor) -> torch.Tensor:
    """Whether each key is a selecting entry of the mask: a binary search
    in the mask's ascending keys, then the selection at the slot found."""
    if m_keys.shape[0] == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    idx = torch.searchsorted(m_keys, keys).clamp_(max=m_keys.shape[0] - 1)
    return (m_keys[idx] == keys) & m_sel[idx]


def _carries(A: CsrMatrix, B: CsrMatrix, lanes: torch.Tensor):
    """Per-entry expansion carries of the A entries with >= 1 lane
    (pattern-only; cached in the plan): entry id, lane count (from
    ``lanes``, :func:`entry_lanes`), and the B position of its first
    lane."""
    eid = torch.nonzero(lanes > 0).flatten()
    return eid, lanes[eid], B.indptr.long()[A.indices[eid].long()]


def _expand(carries, total: int):
    """Lane t -> (A entry, B position) for t < total."""
    eid, lens, pos0 = carries
    dev = eid.device
    ec = torch.repeat_interleave(eid, lens, output_size=total)
    starts = torch.cumsum(lens, 0) - lens
    first = torch.repeat_interleave(pos0 - starts, lens, output_size=total)
    return ec, first + torch.arange(total, device=dev)


def _esc_core(sr: Semiring, E: int, m: int, n: int, complement: bool,
              kdt, carries, total: int, a_rowids, a_values, b_indices,
              b_values, m_keys, m_sel, atype: Type, btype: Type):
    """One program of the engine over ``total`` lanes, masked when
    ``m_keys`` is given (:func:`_mask_keys`); returns (indptr, indices,
    rowids, values, nnz tensor) with E+1 slots (E: the lane bucket).
    Counts the lanes that enter the key sort (``esc.sorted_lanes``)."""
    dev = a_rowids.device
    big = torch.iinfo(kdt).max
    sent = m * n                      # output sentinel: row m, col n

    ec, posc = _expand(carries, total)
    i = a_rowids[ec]
    j = b_indices[posc]
    key = i.to(kdt) * n + j.to(kdt)

    xt, yt, zt = sr.xtype, sr.ytype, sr.ztype
    a = cast(value_take(a_values, ec), xt, atype)
    b = cast(value_take(b_values, posc), yt, btype)
    z = cast_result(sr.mult(a, b), zt)

    if m_keys is not None:
        member = _in_mask(m_keys, m_sel, key)
        key = torch.where(member != complement, key, big)
    counters.count("esc.sorted_lanes", total)
    ks, order = torch.sort(key, stable=True)
    zs = value_take(z, order)

    head = torch.ones(total, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    if m_keys is not None:
        # a masked-out lane heads a segment of its own: its value
        # reaches no output, and no two of them fold onto one slot
        head[1:] |= ks[1:] == big
    seg = torch.cumsum(head, 0) - 1
    seg_vals = segment_fold(sr.add, zs, seg, total + 1, zt)

    # compact: one output slot per live head
    out_head = head & (ks < big)
    r = torch.cumsum(out_head, 0) - 1
    nnzC = out_head.sum()
    tgt = torch.where(out_head, r, E + 1)
    out_keys = torch.full((E + 2,), sent, dtype=kdt, device=dev)
    out_keys.scatter_(0, tgt, ks)
    out_vals = tree_map(
        lambda o, v: o.scatter_(0, tgt, v[seg].to(o.dtype))[:E + 1],
        zeros_like_typed((E + 2,), zt, dev), seg_vals)
    out_keys = out_keys[:E + 1]
    return _assemble(out_keys, sent, m, n) + (out_vals, nnzC)


def _assemble(out_keys: torch.Tensor, sent: int, m: int, n: int):
    """(indptr, indices, rowids) of compacted keys (sentinel -> row m,
    column n).  The keys must ascend, the sentinels last: each caller
    (``_esc_core``, ``_merge_partials``, ``valdot._combine``,
    ``mask._epilogue``) scatters keys that ascend (sorted, or a CSR's
    in storage order) to their ``cumsum`` ranks over a tail of
    sentinels, so the row ids ascend too and the row pointers are a
    binary search in them."""
    is_sent = out_keys == sent
    oi = torch.where(is_sent, m, out_keys // n).to(torch.int32)
    oj = torch.where(is_sent, n, out_keys % n).to(torch.int32)
    indptr = torch.searchsorted(
        oi, torch.arange(m + 1, dtype=oi.dtype, device=oi.device),
        out_int32=True)
    return indptr, oj, oi


def _ref(x):
    if x is None:
        return lambda: None
    return weakref.ref(x)


def csr_spgemm(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
               mask: Optional[CsrMatrix] = None,
               complement: bool = False,
               structural: bool = False) -> CsrMatrix:
    """C<M> = A *.sr* B, CSR x CSR -> CSR, any semiring, O(flops).

    ``mask``: optional CsrMatrix whose truthy entries select output
    positions (GraphBLAS valued-mask semantics; ``structural`` selects
    on the pattern); ``complement`` flips it.  The flop total and the
    output nnz are cached per (A, B, mask) with the expansion carries,
    keyed weakly on the operands' tensors, so repeated calls read no
    scalar back from the device.  A plan build (the spans
    ``gb.planning.esc_plan``) counts ``plan.esc.built``, a cached plan
    ``plan.esc.reused``; the product itself is ``gb.engines.esc``."""
    faultinject.checkpoint("csr_spgemm")
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (m, n):
        raise DimensionMismatch(f"mask {mask.shape} vs output {(m, n)}")
    zt = sr.ztype

    # key dtype: int32 sorts faster
    if (m + 1) * n < (1 << 31):
        kdt = torch.int32
    elif (m + 1) * n < (1 << 63):
        kdt = torch.int64
    else:
        raise NotImplementedError(
            "dimension product exceeds 2^63; use a HyperMatrix output "
            "(the pair-key engine of sparse.hyper)")

    pkey = ("_spgemm_plan", bool(complement), bool(structural))
    # a valued (non-structural) mask keys output nnz on its VALUES too
    mask_buf = mask.indices if mask is not None else None
    mask_vbuf = (mask.values if mask is not None and not structural
                 else None)
    plan = A._options.get(pkey)
    flops = nnz_known = carries = None
    if plan is not None:
        rb, rm, rmv, pf, pn, pc = plan
        if rb() is B.indices and rm() is mask_buf and rmv() is mask_vbuf:
            flops, nnz_known, carries = pf, pn, pc

    if flops is None:
        counters.count("plan.esc.built")
        with counters.span("gb.planning.esc_plan"):
            lanes = entry_lanes(A, B)
            flops = host_read(lanes.sum(), "esc_flops")
    else:
        counters.count("plan.esc.reused")
    if flops == 0 or (mask is not None and not complement
                      and mask.nvals == 0):
        return _empty_csr(m, n, zt, A.device)
    if flops > _ESC_LANE_CAP:
        return _csr_spgemm_chunked(sr, A, B, mask, complement, structural)
    E = _bucket4(flops)
    if carries is None:              # a plan build: lanes made above
        with counters.span("gb.planning.esc_plan"):
            carries = _carries(A, B, lanes)

    with counters.span("gb.engines.esc"):
        m_keys, m_sel = (_mask_keys(mask, n, kdt, structural)
                         if mask is not None else (None, None))
        indptr, oj, oi, ov, nnzC = _esc_core(
            sr, E, m, n, complement, kdt, carries, flops, A.rowids,
            A.values, B.indices, B.values, m_keys, m_sel, A.type, B.type)
        if nnz_known is not None:
            nnz = nnz_known          # plan hit: nothing read back
        else:
            # the one scalar read of a cold call
            nnz = host_read(nnzC, "esc_nnz")
            A._options[pkey] = (_ref(B.indices), _ref(mask_buf),
                                _ref(mask_vbuf), flops, nnz, carries)
        cap = min(_bucket(max(nnz, 8)), E + 1)
    record_axb_method("esc:csr_spgemm")
    return CsrMatrix(indptr, oj[:cap], oi[:cap], tree_map(lambda v: v[:cap], ov), nnz, m, n, zt)


def _csr_spgemm_chunked(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
                        mask, complement: bool,
                        structural: bool) -> CsrMatrix:
    """Huge products: contiguous A-entry blocks at flop-balanced
    boundaries (the GB_AxB_parallel.c:52-59 slicing plan), each block
    through the one-program engine, partials merged pairwise with the
    add monoid (blocks partition A's entries, so a shared output key is
    a genuine split segment).  The blocks are cached on A, keyed weakly
    on B and the mask, so each block's own plan cache hits on warm
    calls."""
    m, k = A.shape
    n = B.ncols
    mask_buf = mask.indices if mask is not None else None
    ckey = "_spgemm_chunks"
    entry = A._options.get(ckey)
    blocks = None
    if entry is not None:
        rb, rm, blocks_c = entry
        if rb() is B.indices and rm() is mask_buf:
            blocks = blocks_c
    if blocks is None:
        csum = host_read(torch.cumsum(entry_lanes(A, B)[:A.nvals], 0),
                         "esc_block_lanes", np.ndarray)
        blocks = []
        dev = A.device
        for s0, e0 in flop_blocks(csum, _ESC_LANE_CAP):
            cap = _bucket(max(e0 - s0, 8), 128)
            pad = cap - (e0 - s0)
            blk = CsrMatrix(
                A.indptr,
                torch.cat([A.indices[s0:e0],
                           torch.full((pad,), k, dtype=A.indices.dtype,
                                      device=dev)]),
                torch.cat([A.rowids[s0:e0],
                           torch.full((pad,), m, dtype=A.rowids.dtype,
                                      device=dev)]),
                tree_map(lambda v: torch.cat([
                    v[s0:e0], torch.zeros(pad, dtype=v.dtype, device=dev)]),
                    A.values),
                e0 - s0, m, A.ncols, A.type)
            blocks.append(blk)
        A._options[ckey] = (_ref(B.indices), _ref(mask_buf), blocks)
    out = None
    for blk in blocks:
        part = csr_spgemm(sr, blk, B, mask=mask, complement=complement,
                          structural=structural)
        out = part if out is None else _merge_partials(sr, out, part, m, n)
    record_axb_method("esc:chunked")
    return out if out is not None else _empty_csr(m, n, sr.ztype, A.device)


def _merge_partials(sr: Semiring, P: CsrMatrix, Q: CsrMatrix,
                    m: int, n: int) -> CsrMatrix:
    """Union-merge two partial CSR outputs with the add monoid on shared
    keys (split segments across block boundaries)."""
    zt = sr.ztype
    dev = P.device
    kdt = torch.int32 if (m + 1) * n < (1 << 31) else torch.int64
    big = torch.iinfo(kdt).max

    def keys_of(X):
        live = torch.arange(X.nzmax, device=dev) < X.nvals
        return torch.where(live, X.rowids.to(kdt) * n + X.indices.to(kdt),
                           big)
    keys = torch.cat([keys_of(P), keys_of(Q)])
    tags = torch.cat([torch.zeros(P.nzmax, dtype=torch.bool, device=dev),
                      torch.ones(Q.nzmax, dtype=torch.bool, device=dev)])
    va = tree_map(lambda p, q: torch.cat([p, torch.zeros_like(q)]),
                  P.values, Q.values)
    vb = tree_map(lambda p, q: torch.cat([torch.zeros_like(p), q]),
                  P.values, Q.values)
    ok, ov, nnz = esc_combine(
        keys, tags, va, vb, zt, True, big,
        pair_fn=lambda a, b: sr.add.op(a, b),
        single_a_fn=lambda a: a, single_b_fn=lambda b: b)
    nnz = host_read(nnz, "esc_merge_nnz")
    E = ok.shape[0]
    indptr, oj, oi = _assemble(torch.where(ok == big, m * n, ok), m * n,
                               m, n)
    cap = min(_bucket(max(nnz, 8)), E)
    return CsrMatrix(indptr, oj[:cap], oi[:cap], tree_map(lambda v: v[:cap], ov), nnz, m, n, zt)


def _empty_csr(m: int, n: int, t: Type, device) -> CsrMatrix:
    cap = 8
    return CsrMatrix(torch.zeros(m + 1, dtype=torch.int32, device=device),
                     torch.full((cap,), n, dtype=torch.int32, device=device),
                     torch.full((cap,), m, dtype=torch.int32, device=device),
                     zeros_like_typed((cap,), t, device), 0, m, n, t)


# ---------------------------------------------------------------------------
# shared sort-combine core for eWise merges
# ---------------------------------------------------------------------------

def esc_combine(keys, tags, vals_a, vals_b, ztype: Type,
                union: bool, big, pair_fn, single_a_fn, single_b_fn):
    """Union/intersection merge of two tagged, keyed tuple sets.

    ``keys``: concatenated linear keys (dead lanes == big); ``tags``:
    False for A lanes, True for B lanes; ``vals_a``/``vals_b``: values
    aligned with keys (each meaningful on its own lanes).  A key present
    in both sets produces ``pair_fn(a, b)``; a singleton produces
    ``single_a_fn(a)`` / ``single_b_fn(b)`` (union=True) or is dropped
    (union=False).  All three return ``ztype`` storage.  Returns
    (out_keys[E+1], out_vals[E+1], nnz) with dead slots keyed ``big``:
    the 4-case merge of ``GB_add.c`` / ``GB_emult.c`` as one sort and
    one vectorized pass."""
    E = keys.shape[0]
    dev = keys.device
    # stable: A lanes stay before B lanes of the same key
    ks, perm = torch.sort(keys, stable=True)
    tg = tags[perm]
    va = value_take(vals_a, perm)
    vb = value_take(vals_b, perm)
    head = torch.ones(E, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    nxt_same = torch.zeros(E, dtype=torch.bool, device=dev)
    nxt_same[:-1] = ks[1:] == ks[:-1]
    live = ks < big
    vb_next = tree_map(lambda v: torch.cat([v[1:], v[-1:]]), vb)
    is_pair = head & nxt_same & live
    out_v = tree_where(is_pair, cast_result(pair_fn(va, vb_next), ztype),
                       tree_where(tg, cast_result(single_b_fn(vb), ztype),
                                  cast_result(single_a_fn(va), ztype)))
    keep = head & live if union else is_pair
    r = torch.cumsum(keep, 0) - 1
    nnz = keep.sum()
    tgt = torch.where(keep, r, E + 1)
    out_keys = torch.full((E + 2,), big, dtype=ks.dtype, device=dev)
    out_keys.scatter_(0, tgt, ks)
    out_vals = tree_map(lambda o, v: o.scatter_(0, tgt, v)[:E + 1],
                        zeros_like_typed((E + 2,), ztype, dev), out_v)
    return out_keys[:E + 1], out_vals, nnz
