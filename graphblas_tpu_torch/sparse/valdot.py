"""Value-panel masked SpGEMM: numeric semirings through dense value
panels on the heavy columns, ESC on the rest.

Counterpart of ``graphblas_tpu/sparse/valdot.py``:

* the heavy wedge-middle columns k (ranked by the exact per-column flop
  count ``indeg_A(k) * deg_B(k)``, ``GB_AxB_flopcount.c``) are packed,
  one slab of S columns at a time, into dense row-compacted value panels
  ``Av[i, s] = A(i, k_s)`` / ``Bv[j, s] = B(k_s, j)`` plus matching
  bitmaps;
* per slab, a plan-time bitmap pass (the popcount kernel of
  :mod:`bitdot`) finds the mask entries owning at least one (A, B) pair
  there: the slab's live list;
* the masked product entry for live mask entry (i, j) is a gathered-row
  dot ``add.reduce(mult(Av[i, :], Bv[j, :]), where=bits(Ab[i] & Bb[j]))``,
  and slabs merge into the accumulator by the add monoid; the plan-time
  popcounts give the output pattern (an entry exists only when its dot
  has >= 1 term, ``GB_AxB_dot.c`` semantics);
* slabs stop when the next slab's modelled cost exceeds the ESC time of
  the wedges it would cover, and the residual runs the ESC engine with
  the same mask, merged by one sort-merge against the mask keys.

For ``plus_times`` over finite values the zero pads are exact, so the
bitmaps are not read: on a CUDA tensor of float32 or int32 the slab pass
is the hand-written gather-dot kernel (``csrc/valdot.cu``, replacing the
JAX package's fused Pallas kernel ``_gd_jit``), under the JAX package's
gate with "a CUDA tensor" for "not the CPU backend".  That path reads
each slab's panels as compacted rows (:class:`ValRows`: a CSR of
(slot, value) pairs per panel row, built once per plan from the slab's
entries and cached for every slab) and builds no dense value panel.
Every other semiring runs the bitmap variant on the dense panels in
plain torch on both devices (the JAX package computes it outside Pallas
too).

The marginal rule's constants are the JAX package's cost model constants,
not measured on this card; they keep the two packages' engine choices
equal.  The TPU-only parts are gone: no DMA ring, no lane segmentation,
no tile-rowed (8, S/8) panel shape, no environment knobs (the slab width
is the ``level_cols`` argument).  User-defined types come with a later
slice: the plan refuses them, as the JAX package's does.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..core.errors import DimensionMismatch
from ..core.semirings import Semiring
from ..core.types import cast
from ..ops.flopcount import record_axb_method
from ..utils import counters, faultinject
from ..utils.counters import host_read, to_device
from . import bitdot as _bd
from .bitdot import _auto_budget, _bitdot_pass, _host_cols_rows, _pack
from .container import CsrMatrix
from .esc import _assemble, _bucket, csr_spgemm
from .tri import csr_filter_lanes

__all__ = ["ValdotPlan", "ValLevel", "ValRows", "build_valdot_plan",
           "cached_plan", "compact_level", "compact_panel",
           "valdot_masked_spgemm", "valdot_gatherdot",
           "valdot_gatherdot_rows"]

#: slab width in columns (the JAX package's default)
_LEVEL_COLS = 4096

#: per-chunk gathered panel bytes cap of the plain slab pass
_CHUNK_BYTES = 1 << 29

# the marginal slab rule: the JAX package's cost model constants, not
# measured on this card (per-row issue latency, effective row stream
# rate, ESC seconds per residual lane, fixed cost of one slab pass)
_ISSUE_NS = 35e-9
_STREAM_BW = 1.6e12
_ESC_NS = 230e-9
_LEVEL_OVERHEAD_S = 2e-3

#: slab cap; the marginal rule, not the cap, should stop the packing
_MAX_LEVELS = 320

#: (lane, B entry) pairs per chunk of the compacted plain version
_CHUNK_PAIRS = 1 << 24


class ValRows(NamedTuple):
    """A value panel's rows compacted to their entries, a CSR of (slot,
    value) pairs: row r holds ``val[q]`` at slot ``slot[q]`` for q in
    ``[ptr[r], ptr[r+1])``, slots ascending.  ``ptr`` and ``slot`` are
    int32."""
    ptr: torch.Tensor         # (nrows + 1,)
    slot: torch.Tensor        # (nnz,)
    val: torch.Tensor         # (nnz,)


class ValLevel(NamedTuple):
    S: int                    # slot count (the slab width)
    na: int                   # panel rows, A side (pow2-bucketed)
    nb: int
    a_rows: torch.Tensor      # PANEL row per selected A entry
    a_slots: torch.Tensor     # slot per entry (-1 pad)
    a_vals: torch.Tensor      # entry values (xtype storage)
    b_js: torch.Tensor
    b_slots: torch.Tensor
    b_vals: torch.Tensor
    live_idx: torch.Tensor    # mask entries with >=1 pair (pad nzM)
    live_ai: torch.Tensor     # A panel row per live entry
    live_bj: torch.Tensor     # B panel row per live entry
    nlive: int
    packed: Optional[tuple]   # (Av, Bv, Ab, Bb) when cached; Ab/Bb None
                              # on the plus_times path, which skips them
    covered: int              # wedges this slab handles
    rows: Optional[tuple] = None  # (A, B) ValRows on the kernel path


class ValdotPlan(NamedTuple):
    A_light: CsrMatrix        # residual A entries WITH values
    S: int                    # slab width
    kcut: int                 # total packed columns
    covered_lanes: int
    light_lanes: int
    levels: tuple
    cnt: torch.Tensor         # heavy pair count per padded mask entry
    finite_ok: bool = False   # all operand values finite (plan-time)

    @property
    def panel_bytes(self) -> int:
        """Bytes of the cached dense panels and compacted rows."""
        return sum(_nbytes(lv.packed) + _nbytes(lv.rows)
                   for lv in self.levels)


def _nbytes(cached) -> int:
    """Bytes of the tensors in a (nested) tuple; None holds none."""
    if cached is None:
        return 0
    if isinstance(cached, torch.Tensor):
        return cached.numel() * cached.element_size()
    return sum(_nbytes(a) for a in cached)


def _pack_vals(nrows: int, S: int, rows, slots, vals) -> torch.Tensor:
    """Scatter entry values into the (nrows, S) panel (zeros = absent;
    absence is tracked by the bitmaps, not the zeros)."""
    tgt = torch.where(slots >= 0, rows.long() * S + slots.long(),
                      nrows * S)
    out = torch.zeros(nrows * S + 1, dtype=vals.dtype, device=vals.device)
    out.scatter_(0, tgt, vals)
    return out[:nrows * S].reshape(nrows, S)


def _compact_side(nrows: int, S: int, rows, slots, vals) -> ValRows:
    """The (nrows, S) panel that :func:`_pack_vals` would scatter, as
    compacted rows: the entries with a slot, sorted by (row, slot).  A
    slab's (row, slot) pairs are distinct (one operand entry each)."""
    keep = torch.nonzero(slots >= 0).flatten()
    r = rows[keep].long()
    sl = slots[keep]
    order = torch.argsort(r * S + sl.long())
    ptr = torch.zeros(nrows + 1, dtype=torch.int32, device=rows.device)
    if keep.numel():
        ptr[1:] = torch.bincount(r, minlength=nrows).cumsum(0)
    return ValRows(ptr, sl[order].to(torch.int32).contiguous(),
                   vals[keep][order].contiguous())


def compact_level(lv: ValLevel) -> tuple:
    """(A, B) :class:`ValRows` of a slab: its cached compacted rows, or
    compacted now from its entries."""
    if lv.rows is not None:
        return lv.rows
    return (_compact_side(lv.na, lv.S, lv.a_rows, lv.a_slots, lv.a_vals),
            _compact_side(lv.nb, lv.S, lv.b_js, lv.b_slots, lv.b_vals))


def compact_panel(panel: torch.Tensor) -> ValRows:
    """The (nrows, S) panel's rows compacted to their nonzero entries,
    on the panel's device."""
    r, c = torch.nonzero(panel, as_tuple=True)
    return _compact_side(panel.shape[0], panel.shape[1], r.to(torch.int32),
                         c.to(torch.int32), panel[r, c])


def _slot_words(S: int) -> int:
    return max(((S + 31) // 32 + 7) // 8 * 8, 8)


def _plus_times_fast(sr: Semiring, finite_ok: bool) -> bool:
    """Zero panel pads are exact: PLUS over TIMES, finite values."""
    zt = sr.ztype
    return (finite_ok and sr.add.op.name == "PLUS"
            and sr.mult.name in ("TIMES", "TIMES_FLIP")
            and not zt.is_udt and not zt.is_bool)


def _pack_level(lv: ValLevel, bits: bool = True):
    """(Av, Bv, Ab, Bb) of a slab: the cached panels, or packed now.
    ``bits=False`` skips the bitmaps (the plus_times path)."""
    if lv.packed is not None and (lv.packed[2] is not None or not bits):
        return lv.packed
    Av = _pack_vals(lv.na, lv.S, lv.a_rows, lv.a_slots, lv.a_vals)
    Bv = _pack_vals(lv.nb, lv.S, lv.b_js, lv.b_slots, lv.b_vals)
    if not bits:
        return Av, Bv, None, None
    W = _slot_words(lv.S)
    Ab = _pack(lv.na, W, lv.a_rows, lv.a_slots)
    Bb = _pack(lv.nb, W, lv.b_js, lv.b_slots)
    return Av, Bv, Ab, Bb


def _refused_types(sr: Semiring, A: CsrMatrix, B: CsrMatrix) -> bool:
    """The plan's type gate: a user-defined or complex semiring or
    operand takes the ESC engine."""
    return any(t.is_udt or t.is_complex
               for t in (sr.xtype, sr.ytype, sr.ztype, A.type, B.type))


def build_valdot_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                      sr: Semiring,
                      budget_bytes: Optional[int] = None,
                      min_lanes: Optional[int] = None,
                      max_levels: int = _MAX_LEVELS,
                      level_cols: Optional[int] = None
                      ) -> Optional[ValdotPlan]:
    """Host-side plan for C<M> = A *.sr* B over the heavy columns.

    Builds slabs of ``level_cols`` columns in wedge-weight order; each
    slab's live mask entries come from a plan-time bitmap pass (the
    counts are accumulated: they ARE the output pattern); slabs stop at
    the marginal break-even against the ESC residual.  Returns None when
    no slab pays (small flop counts, flat profiles), and for a
    user-defined or complex semiring: those take the ESC engine, whose
    output the slab passes would have to reproduce (the JAX package
    refuses user-defined types here too)."""
    if level_cols is None:
        level_cols = _LEVEL_COLS
    if budget_bytes is None:
        budget_bytes = _auto_budget(M.device)
    if min_lanes is None:
        min_lanes = _bd._MIN_LANES
    if _refused_types(sr, A, B):
        return None
    m, kk = A.shape
    n = B.ncols
    if A.nvals == 0 or B.nvals == 0 or M.nvals == 0:
        return None
    dev = M.device
    a_rows, a_cols = _host_cols_rows(A)
    b_rows, b_cols = _host_cols_rows(B)
    indegA = np.bincount(a_cols, minlength=kk).astype(np.int64)
    degB = np.bincount(b_rows, minlength=kk).astype(np.int64)
    score = indegA * degB
    total = int(score.sum())
    if total < min_lanes:
        return None
    order = np.argsort(score)[::-1]
    csum = np.cumsum(score[order])
    nnzk = int((score > 0).sum())
    isa = np.dtype(sr.xtype.dtype).itemsize
    isb = np.dtype(sr.ytype.dtype).itemsize

    xv = cast(A.values, sr.xtype, A.type)
    yv = cast(B.values, sr.ytype, B.type)
    # plus_times fast-path eligibility: zero panel pads are EXACT when
    # every operand value is finite (inf*0 and nan would poison them)
    finite_ok = True
    for v, t in ((xv, sr.xtype), (yv, sr.ytype)):
        if t.is_float:
            finite_ok = finite_ok and bool(torch.isfinite(v).all())
    fast = _plus_times_fast(sr, finite_ok)
    kernel = _use_kernel(sr, fast, dev)
    # entries sorted by column rank once, so each slab's entries are one
    # contiguous host range
    rankk = np.full(kk, nnzk, np.int64)
    rankk[order[:nnzk]] = np.arange(nnzk)
    a_rank = rankk[a_cols]
    b_rank = rankk[b_rows]
    a_ord = np.argsort(a_rank, kind="stable")
    b_ord = np.argsort(b_rank, kind="stable")
    a_rank_s = a_rank[a_ord]
    b_rank_s = b_rank[b_ord]

    def dev_i32(a):
        return to_device(np.ascontiguousarray(a, np.int32), dev)

    levels = []
    cnt_total = None
    sel_end = 0
    covered_all = 0
    panel_budget_left = budget_bytes // 2
    while len(levels) < max_levels and sel_end < nnzk:
        kcut_l = min(level_cols, nnzk - sel_end)
        cov_l = int(csum[sel_end + kcut_l - 1]) - (
            int(csum[sel_end - 1]) if sel_end else 0)
        # optimistic pre-check: even with zero gather traffic, would a
        # slab covering cov_l wedges beat its fixed overhead?
        if cov_l * _ESC_NS <= _LEVEL_OVERHEAD_S:
            break
        a_lo = int(np.searchsorted(a_rank_s, sel_end))
        a_hi = int(np.searchsorted(a_rank_s, sel_end + kcut_l))
        b_lo = int(np.searchsorted(b_rank_s, sel_end))
        b_hi = int(np.searchsorted(b_rank_s, sel_end + kcut_l))
        ae = a_ord[a_lo:a_hi]          # A entries with col in this slab
        be = b_ord[b_lo:b_hi]
        ra, ainv = np.unique(a_rows[ae], return_inverse=True)
        rb, binv = np.unique(b_cols[be], return_inverse=True)
        na = _bucket(max(len(ra), 8))
        nb = _bucket(max(len(rb), 8))
        S = level_cols
        ca = _bucket(max(len(ae), 8), 128)
        cb = _bucket(max(len(be), 8), 128)
        arr = np.zeros(ca, np.int32)
        arr[:len(ae)] = ainv
        asl = np.full(ca, -1, np.int32)
        asl[:len(ae)] = a_rank[ae] - sel_end
        bjr = np.zeros(cb, np.int32)
        bjr[:len(be)] = binv
        bsl = np.full(cb, -1, np.int32)
        bsl[:len(be)] = b_rank[be] - sel_end
        aidx = np.zeros(ca, np.int64)
        aidx[:len(ae)] = ae
        bidx = np.zeros(cb, np.int64)
        bidx[:len(be)] = be
        av = xv[to_device(aidx, dev)]
        bv = yv[to_device(bidx, dev)]
        z = torch.zeros(8, dtype=torch.int32, device=dev)
        lv = ValLevel(S, na, nb, dev_i32(arr), dev_i32(asl), av,
                      dev_i32(bjr), dev_i32(bsl), bv, z, z, z, 0, None,
                      cov_l)
        W = _slot_words(S)
        Ab = _pack(na, W, lv.a_rows, lv.a_slots)
        Bb = _pack(nb, W, lv.b_js, lv.b_slots)
        # liveness from the bit panels (the row maps are plan-time only)
        amap = np.full(m, -1, np.int32)
        amap[ra] = np.arange(len(ra), dtype=np.int32)
        bmap = np.full(n, -1, np.int32)
        bmap[rb] = np.arange(len(rb), dtype=np.int32)
        amap_d = dev_i32(amap)
        bmap_d = dev_i32(bmap)
        cnt_l = _bitdot_pass(Ab, Bb, amap_d, bmap_d, M)
        # one plan-time read per slab: the live list (and its length)
        lidx = torch.nonzero(cnt_l > 0).flatten()
        nlive = int(lidx.shape[0])
        cost = (nlive * (2 * _ISSUE_NS + S * (isa + isb) / _STREAM_BW)
                + _LEVEL_OVERHEAD_S)
        if cost >= cov_l * _ESC_NS:
            break                       # marginal break-even: stop
        cap = _bucket(max(nlive, 8), 128)
        lidx = torch.cat([lidx, torch.full((cap - nlive,), M.nzmax,
                                           dtype=lidx.dtype, device=dev)])
        lidx_c = lidx.clamp(0, M.nzmax - 1)
        live_ai = amap_d[M.rowids[lidx_c].long().clamp(0, m - 1)]
        live_bj = bmap_d[M.indices[lidx_c].long().clamp(0, n - 1)]
        packed = rows = None
        if kernel:
            # the kernel path reads compacted rows only: every slab's are
            # cached (at most one int32 slot and one value per operand
            # entry), and the budget counts them
            rows = compact_level(lv)
            panel_budget_left -= _nbytes(rows)
        else:
            Av, Bv, _, _ = _pack_level(lv, bits=False)
            cached = (Av, Bv, None, None) if fast else (Av, Bv, Ab, Bb)
            if _nbytes(cached) <= panel_budget_left:
                packed = cached
                panel_budget_left -= _nbytes(cached)
            del Av, Bv, cached
        del Ab, Bb
        levels.append(lv._replace(live_idx=lidx.to(torch.int32),
                                  live_ai=live_ai, live_bj=live_bj,
                                  nlive=nlive, packed=packed, rows=rows))
        cnt_total = cnt_l if cnt_total is None else cnt_total + cnt_l
        covered_all += cov_l
        sel_end += kcut_l
    if not levels:
        return None

    sel_any = np.zeros(kk, bool)
    sel_any[order[:sel_end]] = True
    keep = np.zeros(A.nzmax, bool)
    keep[:A.nvals] = ~sel_any[a_cols]
    A_light = _bd._shrink(csr_filter_lanes(A, torch.from_numpy(keep)))
    return ValdotPlan(A_light, level_cols, sel_end, covered_all,
                      total - covered_all, tuple(levels), cnt_total,
                      finite_ok)


# ---------------------------------------------------------------------------
# the slab pass: plain torch (any semiring) and the gather-dot kernel
# ---------------------------------------------------------------------------

def _valdot_pass(sr: Semiring, Av, Bv, Ab, Bb, live_ai, live_bj,
                 nlive: int, use_bits: bool = True) -> torch.Tensor:
    """Gathered-row masked dot over one slab for its live mask entries,
    in bounded-memory chunks.  Returns acc[ztype] aligned with the
    (padded) live list; lanes at or past ``nlive`` hold the identity
    (bits path) or 0 (plus_times path)."""
    E = live_ai.shape[0]
    na, S = Av.shape
    nb = Bv.shape[0]
    zt = sr.ztype
    dev = Av.device
    per = S * (Av.element_size() + Bv.element_size() + 8) + S // 2
    chunk = max(1 << 10, min(_bucket(max(E, 8), 1 << 10),
                             _CHUNK_BYTES // max(per, 1)))
    out = torch.empty(E, dtype=zt.storage, device=dev)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    for s in range(0, E, chunk):
        ii = live_ai[s:s + chunk].long()
        jj = live_bj[s:s + chunk].long()
        o = ((torch.arange(s, s + ii.shape[0], device=dev) < nlive)
             & (ii >= 0) & (jj >= 0))
        ii = ii.clamp(0, na - 1)
        jj = jj.clamp(0, nb - 1)
        z = sr.mult(Av[ii], Bv[jj]).to(zt.storage)
        if not use_bits:
            # plus_times: zero pads contribute exact zeros
            out[s:s + chunk] = torch.where(o[:, None], z, 0).sum(
                1, dtype=z.dtype)
            continue
        pw = Ab[ii] & Bb[jj]                       # (chunk, W) int32
        bits = ((pw[:, :, None] >> shifts) & 1) != 0
        bits = bits.reshape(pw.shape[0], -1)[:, :S]
        out[s:s + chunk] = sr.add.reduce(z, axis=1,
                                         where=bits & o[:, None])
    return out


def _check_gatherdot_args(Av, Bv, ai, bj):
    dev = Av.device
    if Av.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"gather-dot panels must be float32 or int32, got "
                        f"{Av.dtype}")
    if Bv.dtype != Av.dtype:
        raise TypeError(f"panel dtypes differ: {Av.dtype} vs {Bv.dtype}")
    if Av.dim() != 2 or Bv.dim() != 2 or Av.shape[1] != Bv.shape[1]:
        raise ValueError(f"panels must be (na, S) and (nb, S), got "
                         f"{tuple(Av.shape)} and {tuple(Bv.shape)}")
    S = Av.shape[1]
    if S % 4:
        raise ValueError(f"panel width S={S} is not a multiple of 4")
    for name, x in (("ai", ai), ("bj", bj)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
    if ai.shape != bj.shape:
        raise ValueError("ai and bj differ in length")
    for name, x in (("Av", Av), ("Bv", Bv), ("ai", ai), ("bj", bj)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if Av.shape[0] == 0 or Bv.shape[0] == 0:
        raise ValueError("empty panel")
    if Av.data_ptr() % 16 or Bv.data_ptr() % 16:
        raise ValueError("panel rows must start 16-byte aligned")
    return dev


def _gatherdot_plain(Av: torch.Tensor, Bv: torch.Tensor, ai: torch.Tensor,
                     bj: torch.Tensor, nlive: int) -> torch.Tensor:
    """Plain version of the gather-dot kernel: ``(Av[ai] * Bv[bj]).sum(1)``
    over chunks of lanes (indices clipped to the panels' rows), int32
    wrapping; 0 at and past ``nlive``."""
    E = ai.shape[0]
    na, S = Av.shape
    nb = Bv.shape[0]
    nlive = min(int(nlive), E)
    out = torch.zeros(E, dtype=Av.dtype, device=Av.device)
    step = max(1, (1 << 24) // max(S, 1))
    for s in range(0, nlive, step):
        e = min(s + step, nlive)
        a = Av[ai[s:e].long().clamp(0, na - 1)]
        b = Bv[bj[s:e].long().clamp(0, nb - 1)]
        out[s:e] = (a * b).sum(1, dtype=Av.dtype)
    return out


def valdot_gatherdot(Av: torch.Tensor, Bv: torch.Tensor, ai: torch.Tensor,
                     bj: torch.Tensor, nlive: int) -> torch.Tensor:
    """out[t] = sum_s Av[clip(ai[t]), s] * Bv[clip(bj[t]), s] for
    t < nlive, 0 past it; (len(ai),) of the panels' dtype (float32 or
    int32, which wraps).  CUDA tensors launch the gather-dot kernel
    (``csrc/valdot.cu``); CPU tensors run its plain version."""
    dev = _check_gatherdot_args(Av, Bv, ai, bj)
    if dev.type == "cpu":
        return _gatherdot_plain(Av, Bv, ai, bj, nlive)
    E = ai.shape[0]
    out = torch.zeros(E, dtype=Av.dtype, device=dev)
    _build.launch(
        "valdot_gatherdot", Av,
        Av.data_ptr(), Bv.data_ptr(), ai.data_ptr(), bj.data_ptr(),
        out.data_ptr(), min(int(nlive), E), Av.shape[0], Bv.shape[0],
        Av.shape[1], int(Av.dtype == torch.int32))
    return out


def _check_rows_args(Ar: ValRows, Br: ValRows, ai, bj, S: int):
    dev = Ar.val.device
    if Ar.val.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"gather-dot values must be float32 or int32, got "
                        f"{Ar.val.dtype}")
    if Br.val.dtype != Ar.val.dtype:
        raise TypeError(f"value dtypes differ: {Ar.val.dtype} vs "
                        f"{Br.val.dtype}")
    if S <= 0 or S % 4:
        raise ValueError(f"slot count S={S} is not a positive multiple "
                         f"of 4")
    for side, R in (("A", Ar), ("B", Br)):
        for name, x in zip(ValRows._fields, R):
            if x.dim() != 1 or (name != "val" and x.dtype != torch.int32):
                raise TypeError(f"{side}.{name} must be a 1-D int32 tensor, "
                                f"got {x.dtype} {tuple(x.shape)}")
        if R.ptr.shape[0] < 2:
            raise ValueError(f"{side} has no rows")
        if R.slot.shape != R.val.shape:
            raise ValueError(f"{side}.slot and {side}.val differ in length")
    for name, x in (("ai", ai), ("bj", bj)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
    if ai.shape != bj.shape:
        raise ValueError("ai and bj differ in length")
    for name, x in (("A", Ar.ptr), ("A", Ar.slot), ("A", Ar.val),
                    ("B", Br.ptr), ("B", Br.slot), ("B", Br.val),
                    ("ai", ai), ("bj", bj)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _gatherdot_rows_plain(Ar: ValRows, Br: ValRows, ai: torch.Tensor,
                          bj: torch.Tensor, nlive: int,
                          S: int) -> torch.Tensor:
    """Plain version of the compacted gather-dot kernel, a segment sum:
    per lane, its B row's entries, each times A's value at the same slot
    (a search of A's sorted (row, slot) keys; 0 where A has none),
    summed into the lane (``index_add_``, int32 wrapping), in chunks of
    at most _CHUNK_PAIRS pairs; 0 at and past ``nlive``."""
    E = ai.shape[0]
    na, nb = Ar.ptr.shape[0] - 1, Br.ptr.shape[0] - 1
    nlive = max(0, min(int(nlive), E))
    dev = ai.device
    out = torch.zeros(E, dtype=Ar.val.dtype, device=dev)
    if Ar.slot.numel() == 0:
        return out                    # A holds no entry: every dot is 0
    arow = torch.repeat_interleave(torch.arange(na, device=dev),
                                   (Ar.ptr[1:] - Ar.ptr[:-1]).long())
    akey = arow * S + Ar.slot.long()               # ascending
    ii = ai[:nlive].long().clamp(0, na - 1)
    jj = bj[:nlive].long().clamp(0, nb - 1)
    bptr = Br.ptr.long()
    lens = bptr[jj + 1] - bptr[jj]
    ends = lens.cumsum(0)
    s = 0
    while s < nlive:
        # lanes [s, e): at least one, else at most _CHUNK_PAIRS pairs
        base = int(ends[s - 1]) if s else 0
        e = int(torch.searchsorted(ends, base + _CHUNK_PAIRS, right=True))
        e = min(max(e, s + 1), nlive)
        ln = lens[s:e]
        ent = torch.repeat_interleave(torch.arange(e - s, device=dev), ln)
        first = (ln.cumsum(0) - ln)[ent]
        q = bptr[jj[s:e]][ent] + torch.arange(ent.numel(), device=dev) - first
        key = ii[s:e][ent] * S + Br.slot[q].long()
        pos = torch.searchsorted(akey, key).clamp(max=akey.numel() - 1)
        prod = torch.where(akey[pos] == key, Ar.val[pos] * Br.val[q], 0)
        out[s:e].index_add_(0, ent, prod)
        s = e
    return out


def valdot_gatherdot_rows(Ar: ValRows, Br: ValRows, ai: torch.Tensor,
                          bj: torch.Tensor, nlive: int,
                          S: int) -> torch.Tensor:
    """The gather-dot over compacted panel rows: out[t] = sum_s
    A[clip(ai[t]), s] * B[clip(bj[t]), s] for t < nlive, 0 past it, with
    A and B the (na, S) and (nb, S) panels whose rows ``Ar`` and ``Br``
    compact; (len(ai),) of their dtype (float32 or int32, which wraps).
    CUDA tensors launch the compacted gather-dot kernel
    (``csrc/valdot.cu``); CPU tensors run its plain version."""
    dev = _check_rows_args(Ar, Br, ai, bj, S)
    if dev.type == "cpu":
        return _gatherdot_rows_plain(Ar, Br, ai, bj, nlive, S)
    E = ai.shape[0]
    out = torch.empty(E, dtype=Ar.val.dtype, device=dev)
    _build.launch(
        "valdot_gatherdot_rows", Ar.val,
        Ar.ptr.data_ptr(), Ar.slot.data_ptr(), Ar.val.data_ptr(),
        Br.ptr.data_ptr(), Br.slot.data_ptr(), Br.val.data_ptr(),
        ai.data_ptr(), bj.data_ptr(), out.data_ptr(), E,
        max(0, min(int(nlive), E)), Ar.ptr.shape[0] - 1,
        Br.ptr.shape[0] - 1, S, int(Ar.val.dtype == torch.int32))
    return out


def _use_kernel(sr: Semiring, fast: bool, device: torch.device) -> bool:
    """The JAX package's fused-kernel gate (``valdot.py:550-558``), with
    "a CUDA tensor" for its "not the CPU backend"; the TPU's 16 KB
    panel-row cap (scoped VMEM) has no counterpart on the card.  A slab
    width the kernel cannot take (not a multiple of 4) makes the wrapper
    raise; it never falls back to the plain pass.  The plan reads this
    gate too: on the kernel path it caches compacted rows, not panels."""
    zd = np.dtype(sr.ztype.dtype)
    return (fast and device.type == "cuda"
            and np.dtype(sr.xtype.dtype) == zd
            and np.dtype(sr.ytype.dtype) == zd
            and zd in (np.dtype(np.float32), np.dtype(np.int32)))


@counters.spanned("gb.engines.valdot_slabs")
def _valdot_heavy(plan: ValdotPlan, sr: Semiring, M: CsrMatrix):
    """All slabs, each gathering value rows only at its live mask
    entries, merged by the add monoid into the full accumulator (the
    identity start makes the plain add correct).  Counts the slabs run
    (``valdot.slabs``) and their live lanes (``valdot.lanes``)."""
    zt = sr.ztype
    dev = M.device
    fast = _plus_times_fast(sr, plan.finite_ok)
    kernel = _use_kernel(sr, fast, dev)
    # one slot past the mask takes the padded lanes' writes
    acc = sr.add.identity_array((M.nzmax + 1,), dev)
    for lv in plan.levels:
        if lv.nlive == 0:
            continue
        counters.count("valdot.slabs")
        counters.count("valdot.lanes", lv.nlive)
        if kernel:
            part = valdot_gatherdot_rows(*compact_level(lv), lv.live_ai,
                                         lv.live_bj, lv.nlive, lv.S)
        else:
            Av, Bv, Ab, Bb = _pack_level(lv, bits=not fast)
            part = _valdot_pass(sr, Av, Bv, Ab, Bb, lv.live_ai, lv.live_bj,
                                lv.nlive, use_bits=not fast)
        idx = lv.live_idx.long().clamp(0, M.nzmax - 1)
        valid = torch.arange(idx.shape[0], device=dev) < lv.nlive
        merged = sr.add.op(acc[idx], part).to(zt.storage)
        acc.scatter_(0, torch.where(valid, idx, M.nzmax), merged)
    return acc[:M.nzmax], plan.cnt


@counters.spanned("gb.engines.valdot_combine")
def _combine(sr: Semiring, E: int, m: int, n: int, m_rowids, m_indices,
             m_nvals: int, m_truthy, acc, cnt, r_rowids, r_indices, r_vals,
             r_nvals: int, r_type):
    """Merge the heavy per-mask-entry dots with the residual ESC output
    (a CSR subset of the mask) and compact to padded CSR arrays."""
    dev = acc.device
    nzR = r_rowids.shape[0]
    lane_m = torch.arange(E, device=dev)
    m_live = (lane_m < m_nvals) & m_truthy
    # a CSR's keys ascend in storage order, padding last: the mask entry
    # a residual lane lands on is a binary search in the mask's keys
    # (the residual is a CSR subset of the mask; the JAX package merges
    # both in one sort and takes a running maximum of the lane ids)
    mk = m_rowids.long() * n + m_indices.long()
    rk = r_rowids.long() * n + r_indices.long()
    rl = torch.arange(nzR, device=dev) < r_nvals
    r_at = torch.where(rl, torch.searchsorted(mk, rk), E)
    res_val = torch.zeros(E + 1, dtype=r_vals.dtype, device=dev)
    res_val.scatter_(0, r_at, r_vals)
    res_has = torch.zeros(E + 1, dtype=torch.bool, device=dev)
    res_has.scatter_(0, r_at, torch.ones_like(r_at, dtype=torch.bool))
    res_val, res_has = res_val[:E], res_has[:E]

    zt = sr.ztype
    rv = cast(res_val, zt, r_type)
    both = (cnt > 0) & res_has
    merged = sr.add.op(acc, rv).to(zt.storage)
    val = torch.where(both, merged, torch.where(res_has, rv, acc))
    present = m_live & ((cnt > 0) | res_has)

    r = torch.cumsum(present, 0) - 1
    nnzC = present.sum()
    tgt = torch.where(present, r, E + 1)
    keys = torch.full((E + 2,), m * n, dtype=torch.int64, device=dev)
    keys.scatter_(0, tgt, mk)
    ov = torch.zeros(E + 2, dtype=val.dtype, device=dev)
    ov.scatter_(0, tgt, val)
    indptr, oj, oi = _assemble(keys[:E], m * n, m, n)
    return indptr, oj, oi, ov[:E], nnzC


_NO_PLAN = object()


def _cached_entry(M, A, B, sr):
    """The plan (or ``_NO_PLAN``) cached on M for these operands, None
    when nothing is cached for them.  Panels depend on the operand
    patterns AND values, so the cache keys on both (weakly: a dead
    operand cannot alias a stale plan)."""
    entry = M._options.get(("valdot_plan", sr.xtype.name, sr.ytype.name))
    if entry is not None:
        ra, rav, rb, rbv, plan = entry
        if (ra() is A.indices and rav() is A.values
                and rb() is B.indices and rbv() is B.values):
            return plan
    return None


def cached_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                sr: Semiring) -> Optional[ValdotPlan]:
    """The plan that :func:`valdot_masked_spgemm` cached on M for
    (A, B, sr); None when none is cached or the plan refused."""
    plan = _cached_entry(M, A, B, sr)
    return None if plan is _NO_PLAN else plan


def _cached_plan(M, A, B, sr, budget_bytes):
    """Per-(M, A, B, semiring-types) plan cache on M.  A build (the span
    ``gb.planning.valdot_plan``) counts ``plan.valdot.built``, a cached
    plan or refusal ``plan.valdot.reused``."""
    plan = _cached_entry(M, A, B, sr)
    if plan is None:
        counters.count("plan.valdot.built")
        with counters.span("gb.planning.valdot_plan"):
            plan = build_valdot_plan(M, A, B, sr,
                                     budget_bytes=budget_bytes)
        M._options[("valdot_plan", sr.xtype.name, sr.ytype.name)] = (
            weakref.ref(A.indices), weakref.ref(A.values),
            weakref.ref(B.indices), weakref.ref(B.values),
            _NO_PLAN if plan is None else plan)
        return plan
    counters.count("plan.valdot.reused")
    return None if plan is _NO_PLAN else plan


def valdot_masked_spgemm(sr: Semiring, A: CsrMatrix, B: CsrMatrix,
                         M: CsrMatrix, structural: bool = False,
                         budget_bytes: Optional[int] = None
                         ) -> Optional[CsrMatrix]:
    """C<M> = A *.sr* B through the value-panel engine (heavy columns)
    with the ESC engine on the residual.  Returns None when the plan
    refuses (small flop counts, flat profiles, UDT): the caller falls
    back to the pure ESC path.  Non-complemented masks only.  Engine
    names: ``valdot:full``, ``valdot:hybrid`` (as in the JAX package)."""
    faultinject.checkpoint("valdot_masked_spgemm")
    m, k = A.shape
    n = B.ncols
    if M.shape != (m, n):
        raise DimensionMismatch(f"mask {M.shape} vs product {(m, n)}")
    if _refused_types(sr, A, B):
        return None
    plan = _cached_plan(M, A, B, sr, budget_bytes)
    if plan is None:
        return None
    acc, cnt = _valdot_heavy(plan, sr, M)
    dev = M.device
    zt = sr.ztype
    if plan.A_light.nvals:
        R = csr_spgemm(sr, plan.A_light, B, mask=M, structural=structural)
        record_axb_method("valdot:hybrid")    # after the ESC record
        r_args = (R.rowids, R.indices, R.values, R.nvals, R.type)
    else:
        record_axb_method("valdot:full")
        z8 = torch.zeros(8, dtype=torch.int32, device=dev)
        r_args = (z8, z8, torch.zeros(8, dtype=zt.storage, device=dev), 0,
                  zt)
    if structural:
        m_truthy = torch.ones(M.nzmax, dtype=torch.bool, device=dev)
    else:
        m_truthy = M.values != 0
    indptr, oj, oi, ov, nnzC = _combine(
        sr, M.nzmax, m, n, M.rowids, M.indices, M.nvals, m_truthy, acc, cnt,
        *r_args)
    nnz = host_read(nnzC, "valdot_nnz")
    cap = min(_bucket(max(nnz, 8)), M.nzmax + 1)
    return CsrMatrix(indptr, oj[:cap], oi[:cap], ov[:cap], nnz, m, n, zt)
