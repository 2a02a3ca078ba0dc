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
     (stable); masked-out and padded lanes fall to the tail.  The mask
     is applied before the fold: its sorted keys ride the same sort,
     tagged to land just before their lanes, and a lane belongs to the
     mask when the mask key sorted last before it equals its own;
  3. *compress*: segment heads mark unique output coordinates; the add
     monoid folds each segment (named monoids scatter-reduce; any other
     associative op takes a segmented scan), and head lanes compact to
     the padded output.

The JAX package's running-maximum pass (``lax.cummax``) over the mask
keys is a gather here: the keys are sorted, so the running maximum at a
lane is the key of mask entry ``cumsum(is_mask) - 1``.

Capacity planning reads two scalars on a cold call (the flop total, from
the host patterns when present, and the output nnz); both are kept in a
per-(A, B, mask) plan cache with the expansion carries, so warm calls
read nothing back.

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
from ..ops.flopcount import record_axb_method
from ..utils import faultinject
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


def _mask_keys(M: CsrMatrix, n: int, kdt, big: int,
               structural: bool = False) -> torch.Tensor:
    """Sorted truthy-entry keys of the mask (padded lanes -> big)."""
    dev = M.device
    live = torch.arange(M.nzmax, device=dev) < M.nvals
    if not structural:
        if M.type.is_udt:
            raise TypeError("a mask with user-defined values is not valid; "
                            "use a structural mask")
        live = live & (M.values != 0)
    keys = M.rowids.to(kdt) * n + M.indices.to(kdt)
    keys = torch.where(live, keys, big)
    return torch.sort(keys).values


def _carries(A: CsrMatrix, B: CsrMatrix):
    """Per-entry expansion carries of the A entries with >= 1 lane
    (pattern-only; cached in the plan): entry id, lane count, and the
    B position of its first lane."""
    k = A.ncols
    dev = A.device
    degB = torch.cat([(B.indptr[1:] - B.indptr[:-1]).long(),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    acol = A.indices.long().clamp(max=k)
    lens = degB[acol]                 # padded entries hit the 0 sentinel
    lens = torch.where(torch.arange(A.nzmax, device=dev) < A.nvals,
                       lens, 0)
    eid = torch.nonzero(lens > 0).flatten()
    bstart = torch.cat([B.indptr.long(),
                        torch.zeros(1, dtype=torch.int64, device=dev)])
    return eid, lens[eid], bstart[acol[eid]]


def _expand(carries, total: int):
    """Lane t -> (A entry, B position) for t < total."""
    eid, lens, pos0 = carries
    dev = eid.device
    ec = torch.repeat_interleave(eid, lens, output_size=total)
    starts = torch.cumsum(lens, 0) - lens
    first = torch.repeat_interleave(pos0 - starts, lens, output_size=total)
    return ec, first + torch.arange(total, device=dev)


def _esc_core(sr: Semiring, E: int, m: int, n: int, has_mask: bool,
              complement: bool, kdt, carries, total: int,
              a_rowids, a_values, b_indices, b_values, m_keys,
              atype: Type, btype: Type):
    """One program of the engine over ``total`` lanes; returns
    (indptr, indices, rowids, values, nnz tensor) with EO+1 slots, EO =
    E (the lane bucket) plus the mask's length: the JAX package's
    output layout."""
    dev = a_rowids.device
    intmax = torch.iinfo(kdt).max
    # bigbase survives the *2+1 tag encoding of the mask merge
    bigbase = intmax // 2 - 1
    big = intmax
    sent = m * n                      # output sentinel: row m, col n

    ec, posc = _expand(carries, total)
    i = a_rowids[ec]
    j = b_indices[posc]
    key = i.to(kdt) * n + j.to(kdt)

    xt, yt, zt = sr.xtype, sr.ytype, sr.ztype
    a = cast(value_take(a_values, ec), xt, atype)
    b = cast(value_take(b_values, posc), yt, btype)
    z = cast_result(sr.mult(a, b), zt)
    ident = sr.add.identity_value()
    ident_arr = sr.add.identity_array((), dev)

    if has_mask:
        NM = m_keys.shape[0]
        allk = torch.cat([m_keys * 2, key * 2 + 1])
        sk, order = torch.sort(allk, stable=True)
        is_m = order < NM
        zs = tree_map(lambda v, i: torch.cat([
            torch.full((NM,), i, dtype=v.dtype, device=dev), v])[order],
            z, ident)
        # running maximum of the (sorted) mask keys: a gather of the
        # mask key counted so far
        mrank = torch.cumsum(is_m, 0) - 1
        run = torch.where(mrank >= 0, m_keys[mrank.clamp(min=0)] * 2, -1)
        lane = (~is_m) & (sk < bigbase * 2)
        match = lane & (sk == run + 1)
        keep = (lane & ~match) if complement else match
        ks = torch.where(keep, sk >> 1, big)
        zs = tree_where(keep, zs, ident_arr)
    else:
        ks, order = torch.sort(key, stable=True)
        zs = value_take(z, order)
    E2 = ks.shape[0]
    EO = E + (m_keys.shape[0] if has_mask else 0)

    head = torch.ones(E2, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(head, 0) - 1
    seg_vals = segment_fold(sr.add, zs, seg, E2 + 1, zt)

    # compact: one output slot per live head
    out_head = head & (ks < big)
    r = torch.cumsum(out_head, 0) - 1
    nnzC = out_head.sum()
    tgt = torch.where(out_head, r, EO + 1)
    out_keys = torch.full((EO + 2,), sent, dtype=kdt, device=dev)
    out_keys.scatter_(0, tgt, ks)
    out_vals = tree_map(
        lambda o, v: o.scatter_(0, tgt, v[seg].to(o.dtype))[:EO + 1],
        zeros_like_typed((EO + 2,), zt, dev), seg_vals)
    out_keys = out_keys[:EO + 1]
    return _assemble(out_keys, sent, m, n) + (out_vals, nnzC)


def _assemble(out_keys: torch.Tensor, sent: int, m: int, n: int):
    """(indptr, indices, rowids) of compacted sorted keys (sentinel ->
    row m, column n)."""
    is_sent = out_keys == sent
    oi = torch.where(is_sent, m, out_keys // n).to(torch.int32)
    oj = torch.where(is_sent, n, out_keys % n).to(torch.int32)
    counts = torch.bincount(oi.long(), minlength=m + 1)
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=out_keys.device)
    indptr[1:] = torch.cumsum(counts[:m], 0)
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
    scalar back from the device."""
    faultinject.checkpoint("csr_spgemm")
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if mask is not None and mask.shape != (m, n):
        raise DimensionMismatch(f"mask {mask.shape} vs output {(m, n)}")
    zt = sr.ztype

    # key dtype: int32 sorts faster; the masked path carries keys as
    # key*2+1 (the sort-merge tag), one extra bit of headroom
    kbits = 31 if mask is None else 30
    if (m + 1) * n < (1 << kbits):
        kdt = torch.int32
    elif (m + 1) * n < (1 << (kbits + 32)):
        kdt = torch.int64
    else:
        raise NotImplementedError(
            "dimension product exceeds 2^62; use a HyperMatrix output "
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
        hpA = A._options.get("host_pattern")
        hpB = B._options.get("host_pattern")
        if hpA is not None and hpB is not None:
            degB = np.bincount(hpB[0][:B.nvals], minlength=k)
            flops = int(degB[hpA[1][:A.nvals]].sum())
        else:
            degB = torch.cat([(B.indptr[1:] - B.indptr[:-1]).long(),
                              torch.zeros(1, dtype=torch.int64,
                                          device=A.device)])
            lens = degB[A.indices.long().clamp(max=k)][:A.nvals]
            flops = int(lens.sum())
    if flops == 0 or (mask is not None and not complement
                      and mask.nvals == 0):
        return _empty_csr(m, n, zt, A.device)
    if flops > _ESC_LANE_CAP:
        return _csr_spgemm_chunked(sr, A, B, mask, complement, structural,
                                   flops)
    E = _bucket4(flops)
    if carries is None:
        carries = _carries(A, B)

    has_mask = mask is not None
    m_keys = (_mask_keys(mask, n, kdt, torch.iinfo(kdt).max // 2 - 1,
                         structural) if has_mask else None)
    indptr, oj, oi, ov, nnzC = _esc_core(
        sr, E, m, n, has_mask, complement, kdt, carries, flops,
        A.rowids, A.values, B.indices, B.values, m_keys, A.type, B.type)
    if nnz_known is not None:
        nnz = nnz_known          # plan hit: nothing read back
    else:
        nnz = int(nnzC)          # the one scalar read of a cold call
        A._options[pkey] = (_ref(B.indices), _ref(mask_buf),
                            _ref(mask_vbuf), flops, nnz, carries)
    cap = min(_bucket(max(nnz, 8)), E + 1)
    record_axb_method("esc:csr_spgemm")
    return CsrMatrix(indptr, oj[:cap], oi[:cap], tree_map(lambda v: v[:cap], ov), nnz, m, n, zt)


def _csr_spgemm_chunked(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
                        mask, complement: bool, structural: bool,
                        flops: int) -> CsrMatrix:
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
        hpA = A._options.get("host_pattern")
        hpB = B._options.get("host_pattern")
        if hpA is not None and hpB is not None:
            degB = np.bincount(hpB[0][:B.nvals],
                               minlength=k).astype(np.int64)
            csum = np.cumsum(degB[hpA[1][:A.nvals]])
        else:
            degB = (B.indptr[1:] - B.indptr[:-1]).long().cpu().numpy()
            acol = A.indices[:A.nvals].long().cpu().numpy()
            csum = np.cumsum(degB[acol])
        nz = len(csum)
        bounds = [0]
        prev = 0
        while bounds[-1] < nz and prev < flops:
            s0 = bounds[-1]
            nxt = int(np.searchsorted(csum, prev + _ESC_LANE_CAP,
                                      side="right"))
            nxt = min(max(nxt, s0 + 1), nz)
            bounds.append(nxt)
            prev = int(csum[nxt - 1])
        blocks = []
        dev = A.device
        for s0, e0 in zip(bounds[:-1], bounds[1:]):
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
            if hpA is not None:
                blk._options["host_pattern"] = (hpA[0][s0:e0],
                                                hpA[1][s0:e0])
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
    nnz = int(nnz)
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
