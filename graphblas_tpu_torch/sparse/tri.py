"""Sort-merge masked structural counting on CSR: the triangle-counting
engines and their entry points.

Counterpart of ``graphblas_tpu/sparse/tri.py``.  For counting semirings
(PLUS_PAIR on patterns), the masked product C<M> = A·B needs only, per
mask entry e=(i,j), the number of wedges i -> k -> j.  Each A entry
(i, k) expands into one lane per B entry (k, j) with key i*n + j; the
lane keys are sort-merged with M's (already sorted) entry keys, and
each mask entry counts the lanes that carry its key.  Work is split on
the host into flop-balanced blocks of A entries so peak memory stays
bounded.

``tricount_auto`` picks the engine as the JAX package does: the band
kernel for banded graphs, the window kernel for windowed ones, and
``tricount_esc`` (bitmap popcount panels + this sort-merge residual)
for anything else.

Reference counterparts: ``Template/GB_AxB_dot_mask.c`` (masked dot),
``tricount.c`` SandiaDot, ``tri_prep.c``.  k-truss comes with a later
slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.errors import DimensionMismatch
from .container import CsrMatrix
from .cuda_window import tricount_band_partials, window_count_partials
from .window import build_band_plan, build_window_plan

__all__ = ["masked_pair_counts", "tricount_esc", "tricount_auto",
           "tricount_device", "tricount_prep_csr", "csr_filter_lanes",
           "csr_tril", "csr_triu"]

#: lanes per block: the sort-merge holds about ten int64 lane-sized
#: arrays (~80 B/lane), 5.4 GB at 2^26 lanes
_LANE_CAP = 1 << 26

#: key sentinel: real keys are i*n+j < 2^62; padded mask entries sort last
_BIGKEY = (1 << 62) - 1


def _counts_block(ncolsA: int, a_indices, a_rowids, b_indptr, b_indices,
                  m_rowids, m_indices, m_nvals: int, n_out: int,
                  flops: int) -> torch.Tensor:
    """Masked pair counts of one block of A entries against the mask
    slice (m_rowids, m_indices); ``flops`` is the block's lane count.

    Expansion: lane t of A entry a reads B entry indptr[k_a] + t - start_a
    and gets key i_a * n_out + j.  Membership: the mask keys (tagged even)
    and lane keys (tagged odd, so a mask entry sorts before its lanes)
    are sorted together; a lane matches when the last mask entry before
    it carries its key, and counts for that entry.  Mask keys are sorted
    and unique, so that entry's id is the number of mask keys sorted at
    or before the lane, less one."""
    dev = a_indices.device
    nzM = m_indices.shape[0]
    degB = torch.cat([(b_indptr[1:] - b_indptr[:-1]).long(),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    acol = a_indices.long().clamp(max=ncolsA)
    lens = degB[acol]                 # padded entries hit the 0 sentinel
    ent = torch.repeat_interleave(
        torch.arange(a_indices.shape[0], device=dev), lens,
        output_size=flops)            # lane -> A entry
    starts = torch.cumsum(lens, 0) - lens
    pos = (b_indptr.long()[acol][ent] - starts[ent]
           + torch.arange(flops, device=dev))
    key = a_rowids.long()[ent] * n_out + b_indices.long()[pos]

    m_live = torch.arange(nzM, device=dev) < m_nvals
    m_keys = torch.where(m_live, m_rowids.long() * n_out + m_indices.long(),
                         _BIGKEY)
    sk, order = torch.sort(torch.cat([m_keys * 2, key * 2 + 1]),
                           stable=True)
    is_m = order < nzM
    mrank = torch.cumsum(is_m, 0) - 1     # mask entry id at or before
    # the running maximum of the mask keys (the JAX package's cummax) is
    # the key of mask entry mrank, the mask keys being sorted: a gather
    run = torch.where(mrank >= 0, m_keys[mrank.clamp(min=0)] * 2, -1)
    match = (~is_m) & (sk < _BIGKEY * 2) & (sk == run + 1)
    counts = torch.bincount(mrank[match], minlength=nzM)
    return torch.where(m_live, counts, 0).to(torch.int32)


def _entry_flops_csum(A: CsrMatrix, B: CsrMatrix) -> torch.Tensor:
    """int64 cumulative lane count per A entry (padded entries add 0)."""
    degB = torch.cat([(B.indptr[1:] - B.indptr[:-1]).long(),
                      torch.zeros(1, dtype=torch.int64, device=A.device)])
    lens = degB[A.indices.long().clamp(max=A.ncols)]
    lens = torch.where(torch.arange(A.nzmax, device=A.device) < A.nvals,
                       lens, 0)
    return torch.cumsum(lens, 0)


def masked_pair_counts(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                       chunk: int = _LANE_CAP) -> torch.Tensor:
    """counts[e] = (A·B)[i_e, j_e] over PLUS_PAIR for every entry e of M
    (aligned with M's padded CSR entry order; padded slots 0), int32.

    ``chunk`` caps the expanded lanes per block; when the total lane
    count exceeds it, A is split on the host into contiguous entry
    blocks at flop-balanced boundaries (the slicing-by-flops plan of
    ``GB_AxB_parallel.c:52-59``) and each block counts against only the
    mask rows its A rows can reach."""
    m, k = A.shape
    n = B.ncols
    if M.shape != (m, n):
        raise DimensionMismatch(f"mask {M.shape} vs product {(m, n)}")
    csum = _entry_flops_csum(A, B)
    flops = int(csum[-1]) if A.nzmax else 0
    if flops == 0 or M.nvals == 0:
        return torch.zeros(M.nzmax, dtype=torch.int32, device=M.device)
    cap = max(min(chunk, _LANE_CAP), 1 << 14)
    if flops <= cap:
        return _counts_block(k, A.indices, A.rowids, B.indptr, B.indices,
                             M.rowids, M.indices, M.nvals, n, flops)

    # Host split: contiguous A-entry blocks of <= cap lanes each (a
    # block is never empty, so a single entry with more than `cap`
    # lanes still goes through as its own block).
    csum = csum.cpu().numpy()
    nz = A.nzmax
    bounds = [0]
    prev = 0
    while bounds[-1] < nz and prev < flops:
        s = bounds[-1]
        nxt = int(np.searchsorted(csum, prev + cap, side="right"))
        nxt = min(max(nxt, s + 1), nz)
        bounds.append(nxt)
        prev = int(csum[nxt - 1])
    blocks = list(zip(bounds[:-1], bounds[1:]))

    # mask row-slicing: a block covers a contiguous A-entry (= row)
    # range, and its counts can only land on mask entries in those rows,
    # so each block sorts only that slice of the mask
    hpA = A._options.get("host_pattern")
    hpM = M._options.get("host_pattern")
    counts = torch.zeros(M.nzmax, dtype=torch.int32, device=M.device)
    use_slice = hpA is not None and hpM is not None and len(blocks) > 1
    if use_slice:
        a_rows_h = np.asarray(hpA[0][:A.nvals])
        m_rows_h = np.asarray(hpM[0][:M.nvals])
    for s, e in blocks:
        blk_flops = int(csum[e - 1]) - (int(csum[s - 1]) if s else 0)
        if blk_flops == 0:
            continue
        ai, ar = A.indices[s:e], A.rowids[s:e]
        if use_slice:
            r0 = a_rows_h[min(s, A.nvals - 1)]
            r1 = a_rows_h[min(e - 1, A.nvals - 1)]
            ms = int(np.searchsorted(m_rows_h, r0, side="left"))
            me = int(np.searchsorted(m_rows_h, r1, side="right"))
            if me == ms:
                continue
            counts[ms:me] += _counts_block(
                k, ai, ar, B.indptr, B.indices, M.rowids[ms:me],
                M.indices[ms:me], me - ms, n, blk_flops)
        else:
            counts += _counts_block(k, ai, ar, B.indptr, B.indices,
                                    M.rowids, M.indices, M.nvals, n,
                                    blk_flops)
    return counts


def tricount_device(L: CsrMatrix, U: Optional[CsrMatrix] = None,
                    chunk: int = _LANE_CAP) -> torch.Tensor:
    """Sandia triangle count as a 0-d int64 tensor on L's device:
    callers can batch several graphs' counts and read them once."""
    from .bitdot import masked_pair_counts_auto
    B = U if U is not None else L
    counts = masked_pair_counts_auto(L, L, B, chunk)
    return counts.sum(dtype=torch.int64)


def tricount_esc(L: CsrMatrix, U: Optional[CsrMatrix] = None,
                 chunk: int = _LANE_CAP) -> int:
    """Sandia triangle count at CSR scale: ntri = sum over (i,j) in L of
    (L·U)[i,j]; with ``U=None`` the pure-Sandia form (L·L).<L.  Routes
    through the heavy/light bitdot split (:mod:`bitdot`): power-law
    graphs count on bitmaps, the residual on the sort-merge."""
    return int(tricount_device(L, U, chunk))


def tricount_auto(L: CsrMatrix, U: CsrMatrix) -> int:
    """SandiaDot triangle count with engine auto-select:

      1. band-ring kernel — banded graphs, mask == L
      2. window-panel count kernel — clustered/windowed graphs
      3. bitmap popcount + sort-merge counting — any structure

    Engine recorded in ``last_axb_method``."""
    plan = build_band_plan(L, U)
    if plan is not None:
        return int(tricount_band_partials(plan).sum(dtype=torch.int64))
    wplan = build_window_plan(L, U, L)
    if wplan is not None:
        return int(window_count_partials(wplan).sum(dtype=torch.int64))
    return tricount_esc(L, U)


def csr_filter_lanes(A: CsrMatrix, keep) -> CsrMatrix:
    """Entry filter: keep[e] over A's padded entry order -> compacted
    CsrMatrix (the in-place prune of GB_select, sparse form).  Dropped
    entries scatter into a sentinel slot past the end."""
    dev = A.device
    nz = A.nzmax
    keep = (torch.as_tensor(keep, dtype=torch.bool, device=dev)
            & (torch.arange(nz, device=dev) < A.nvals))
    tgt = torch.where(keep, torch.cumsum(keep, 0) - 1, nz)

    def compact(x, fill):
        out = torch.full((nz + 1,), fill, dtype=x.dtype, device=dev)
        return out.scatter_(0, tgt, x)[:nz]

    rowcounts = torch.zeros(A.nrows + 1, dtype=torch.int32, device=dev)
    rowcounts.index_add_(0, A.rowids.long().clamp(max=A.nrows),
                         keep.to(torch.int32))
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(rowcounts[:A.nrows], 0,
                                     dtype=torch.int32)])
    return CsrMatrix(indptr, compact(A.indices, A.ncols),
                     compact(A.rowids, A.nrows), compact(A.values, 0),
                     int(keep.sum()), A.nrows, A.ncols, A.type)


def csr_tril(A: CsrMatrix, k: int = -1) -> CsrMatrix:
    """Entries on/below diagonal k (GxB_TRIL at CSR scale)."""
    return csr_filter_lanes(A, A.indices.long() - A.rowids.long() <= k)


def csr_triu(A: CsrMatrix, k: int = 1) -> CsrMatrix:
    """Entries on/above diagonal k (GxB_TRIU at CSR scale)."""
    return csr_filter_lanes(A, A.indices.long() - A.rowids.long() >= k)


def tricount_prep_csr(A: CsrMatrix):
    """Degree-ascending relabel + L/U split (the reference's
    ``tri_prep.c`` / ``tricount.c`` prep): returns (L, U) of the
    permuted graph on A's device.  For power-law graphs this shrinks the
    SandiaDot wedge count by orders of magnitude (each edge is oriented
    from the lower-degree endpoint)."""
    hp = A._options.get("host_pattern")
    if hp is not None:
        I = np.asarray(hp[0][:A.nvals])
        J = np.asarray(hp[1][:A.nvals])
    else:
        I, J, _ = A.extractTuples()
    n = A.nrows
    deg = np.bincount(I, minlength=n)
    perm = np.argsort(deg, kind="stable")     # old ids in new order
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)
    In, Jn = rank[I], rank[J]
    lo = In > Jn
    up = In < Jn
    L = CsrMatrix.from_coo(In[lo], Jn[lo], np.ones(int(lo.sum()), bool),
                           n, n, type=A.type, sum_duplicates=False,
                           device=A.device)
    U = CsrMatrix.from_coo(In[up], Jn[up], np.ones(int(up.sum()), bool),
                           n, n, type=A.type, sum_duplicates=False,
                           device=A.device)
    return L, U
