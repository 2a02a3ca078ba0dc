"""Bitpacked dot-panel masked counting: structure-independent counting
on any graph shape (the power-law engine).

Counterpart of ``graphblas_tpu/sparse/bitdot.py``.  The contraction
dimension is split by measured wedge weight:

* **heavy k** (top columns by ``indeg_A(k) * deg_B(k)``): membership of
  each selected k in A's rows and B's columns is packed into per-row
  bitmaps of ``W`` 32-bit words, and the masked dot for mask entry
  (i, j) is ``popcount(Apack[i, :] & Bpack[j, :])`` — two W-word row
  reads, AND, popcount, in one CUDA kernel (``csrc/bitdot.cu``);
* **light k** (the residual): the remaining A entries go through the
  sort-merge engine (:mod:`tri`).

A slab's panel keeps only rows that own at least one selected bit,
reached through an (m,)-sized row -> panel-row map (-1 for rows with no
bit), when that saves enough.  Plans are chosen on the host in numpy,
exactly as in the JAX package, so both packages pick the same slabs.

Packed words are int32 tensors holding the bits of the JAX package's
uint32 words.  Re-packing under per-entry liveness (``keep_entry_lists``,
used by k-truss) comes with the k-truss slice.

Semantics: PLUS_PAIR over the pattern, identical to
:func:`tri.masked_pair_counts` (counts aligned with M's padded CSR entry
order) and exact.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..ops.flopcount import record_axb_method
from .bitpack import popcount
from .container import CsrMatrix
from .esc import _bucket
from .tri import csr_filter_lanes, masked_pair_counts

__all__ = ["BitdotPlan", "PackLevel", "build_bitdot_plan",
           "bitdot_counts", "bitdot_popcount", "masked_pair_counts_auto"]

#: the plain popcount pass gathers at most this many words per side at
#: a time
_CHUNK_WORDS = 1 << 24

#: peak panel memory budget (cached level-1 pair + one transient
#: extra-level pair coexist), bytes
_PANEL_BUDGET = 8 << 30

#: don't bother packing unless the heavy slab covers this wedge share
_MIN_COVER = 0.30

#: below this many wedges the sort-merge engine is a single cheap
#: pass and the panel build isn't worth it
_MIN_LANES = 1 << 22

#: stop adding bitmap levels once the residual is below this
_MIN_LEVEL_REM = 1 << 25

#: a level must cover at least this many wedges to pay for its own
#: transient build + gather pass
_MIN_LEVEL_COVER = 1 << 24

#: use a row->panel indirection only when the live-row fraction is
#: below this (otherwise the map read buys nothing)
_COMPACT_FRAC = 0.75


class PackLevel(NamedTuple):
    """One bitmap slab of selected contraction columns.  The first
    level's packed panels are cached on the plan (its entry lists are
    dropped); levels 2+ keep their entry lists and are packed, used and
    freed inside each counts call, so peak memory is one extra pair."""
    W: int                    # 32-bit words per panel row
    na: int                   # panel rows (A side; < m when compacted)
    nb: int                   # panel rows (B side)
    a_rows: torch.Tensor      # PANEL row per selected A entry
    a_slots: torch.Tensor     # bit slot per selected A entry
    b_js: torch.Tensor        # PANEL row per selected B entry
    b_slots: torch.Tensor
    amap: Optional[torch.Tensor]  # (m,) orig row -> panel row / -1
    bmap: Optional[torch.Tensor]  # (n,) orig col -> panel row / -1
    covered: int              # wedges this slab handles


class BitdotPlan(NamedTuple):
    Apack: torch.Tensor       # packed level-1 A panel (cached)
    Bpack: torch.Tensor       # packed level-1 B panel (cached)
    A_light: CsrMatrix        # residual A entries (k in NO slab)
    W: int                    # words per row (level 1)
    kcut: int                 # selected columns, all levels
    covered_lanes: int        # wedges handled by all bitmap levels
    light_lanes: int          # wedges left for the sort-merge engine
    levels: tuple = ()        # ALL PackLevel slabs (level 1 first)

    @property
    def panel_bytes(self) -> int:
        return 4 * (self.Apack.numel() + self.Bpack.numel())


def _host_cols_rows(X: CsrMatrix):
    """(rowids, indices) of live entries as host arrays (host_pattern
    when present, one device copy otherwise)."""
    hp = X._options.get("host_pattern")
    if hp is not None:
        return (np.asarray(hp[0][:X.nvals]), np.asarray(hp[1][:X.nvals]))
    return (X.rowids[:X.nvals].cpu().numpy(),
            X.indices[:X.nvals].cpu().numpy())


def _pack(nrows: int, W: int, rows: torch.Tensor,
          slots: torch.Tensor) -> torch.Tensor:
    """Scatter bits 1 << (slot & 31) into word rows*W + slot>>5, as a
    (nrows, W) int32 panel.  Every (row, slot) pair is unique, so add ==
    bitwise-or; the sum runs in int64 and keeps the low 32 bits."""
    live = slots >= 0
    word = rows.long() * W + (slots >> 5).long()
    word = torch.where(live, word, nrows * W)
    bit = torch.where(live, torch.ones_like(word) << (slots & 31).long(), 0)
    acc = torch.zeros(nrows * W + 1, dtype=torch.int64, device=rows.device)
    acc.index_add_(0, word, bit)
    acc = acc[:nrows * W]
    acc = torch.where(acc >= (1 << 31), acc - (1 << 32), acc)
    return acc.to(torch.int32).reshape(nrows, W)


def _round8(w: int) -> int:
    return max((w // 8) * 8, 0)


class _SlabSel(NamedTuple):
    """Host-side selection of one slab (before it goes to the device)."""
    kcut: int
    na: int
    nb: int
    a_idx: np.ndarray         # indices into the host entry arrays (A)
    a_slots: np.ndarray
    b_idx: np.ndarray
    b_slots: np.ndarray
    amap: Optional[np.ndarray]
    bmap: Optional[np.ndarray]
    covered: int


def _select_slab(bud: int, sel_start: int, want_cols: int,
                 order, csum, kk: int, m: int, n: int,
                 a_rows, a_cols, b_rows, b_cols,
                 bpc: float = 0.125,
                 quantum: int = 256) -> Optional[_SlabSel]:
    """Pick the widest slab of columns order[sel_start:...] whose
    row-compacted panel pair fits ``bud`` bytes.  Live-row counts grow
    with the slab, so probe, then grow/shrink to the fixpoint.

    ``bpc``: panel bytes per (row, column) slot — 4/32 for bitmaps.
    ``quantum``: slab width rounding (256 keeps bitmap word counts a
    multiple of 8)."""
    if want_cols <= 0:
        return None

    def live(kcand):
        ksel = order[sel_start:sel_start + kcand]
        pos = np.full(kk, -1, np.int32)
        pos[ksel] = np.arange(kcand, dtype=np.int32)
        am = pos[a_cols] >= 0
        bm = pos[b_rows] >= 0
        ra = np.unique(a_rows[am])
        rb = np.unique(b_cols[bm])
        return pos, am, bm, ra, rb

    def width(rows_total):
        c = int(bud / (bpc * max(rows_total, 1)))
        return (c // quantum) * quantum

    def mem(kcand, na, nb):
        S = max(((kcand + quantum - 1) // quantum) * quantum, quantum)
        return bpc * S * (na + nb)

    # probe at dense-rows width, then retry at the live-row width
    kcand = min(max(width(m + n), quantum), want_cols)
    pos, am, bm, ra, rb = live(kcand)
    na = len(ra) if len(ra) < _COMPACT_FRAC * m else m
    nb = len(rb) if len(rb) < _COMPACT_FRAC * n else n
    for _ in range(3):
        bytes_ = mem(kcand, na, nb)
        grow = min(width(na + nb), want_cols)
        if bytes_ <= bud and grow <= kcand:
            break
        if bytes_ > bud and grow >= kcand:
            break                      # fixpoint within rounding
        kcand = max(grow, quantum) if grow > 0 else kcand
        if grow <= 0:
            return None
        pos, am, bm, ra, rb = live(kcand)
        na = len(ra) if len(ra) < _COMPACT_FRAC * m else m
        nb = len(rb) if len(rb) < _COMPACT_FRAC * n else n
    if mem(kcand, na, nb) > bud:
        # final conservative shrink with the measured live rows
        kcand = width(na + nb)
        if kcand < quantum // 8:
            return None
        kcand = min(kcand, want_cols)
        pos, am, bm, ra, rb = live(kcand)
        na = len(ra) if len(ra) < _COMPACT_FRAC * m else m
        nb = len(rb) if len(rb) < _COMPACT_FRAC * n else n
    if kcand <= 0:
        return None
    covered = int(csum[sel_start + kcand - 1]) - (
        int(csum[sel_start - 1]) if sel_start else 0)
    amap = bmap = None
    if na < m:
        amap = np.full(m, -1, np.int32)
        amap[ra] = np.arange(len(ra), dtype=np.int32)
        arow_panel = amap[a_rows[am]]
    else:
        arow_panel = a_rows[am].astype(np.int32)
    if nb < n:
        bmap = np.full(n, -1, np.int32)
        bmap[rb] = np.arange(len(rb), dtype=np.int32)
        bj_panel = bmap[b_cols[bm]]
    else:
        bj_panel = b_cols[bm].astype(np.int32)
    return _SlabSel(kcand, na, nb,
                    np.nonzero(am)[0], pos[a_cols[am]],
                    np.nonzero(bm)[0], pos[b_rows[bm]],
                    amap, bmap, covered), arow_panel, bj_panel


def _device_level(sel: _SlabSel, arow_panel, bj_panel,
                  device) -> PackLevel:
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    W = max(_round8((sel.kcut + 31) // 32 + 7), 8)
    return PackLevel(
        W, sel.na, sel.nb,
        dev(arow_panel), dev(sel.a_slots), dev(bj_panel), dev(sel.b_slots),
        None if sel.amap is None else dev(sel.amap),
        None if sel.bmap is None else dev(sel.bmap),
        sel.covered)


def build_bitdot_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                      budget_bytes: Optional[int] = None,
                      cover_target: float = 0.995,
                      min_lanes: Optional[int] = None,
                      max_levels: int = 24,
                      ) -> Optional[BitdotPlan]:
    """Host-side plan for counts[e] = (A.B)[i_e, j_e] over PLUS_PAIR.

    Selects the heavy contraction columns by exact wedge weight
    ``indeg_A(k) * deg_B(k)`` into up to ``max_levels`` row-compacted
    bitmap slabs — the first is packed now and cached, the rest are
    kept as compact entry lists and packed per call — and compacts the
    residual A entries for the sort-merge engine.  Returns None when the
    bitmaps can't cover enough wedges to pay."""
    if budget_bytes is None:
        budget_bytes = _PANEL_BUDGET
    if min_lanes is None:
        min_lanes = _MIN_LANES
    m, kk = A.shape
    n = B.ncols
    if A.nvals == 0 or B.nvals == 0 or M.nvals == 0:
        return None
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
    kneed = min(int(np.searchsorted(csum, cover_target * total)) + 1,
                nnzk)

    levels = []
    sel_end = 0
    sel_any = np.zeros(kk, bool)
    while len(levels) < max_levels and sel_end < kneed:
        rem = total - (int(csum[sel_end - 1]) if sel_end else 0)
        if sel_end and rem <= max(min_lanes, _MIN_LEVEL_REM):
            break
        bud = budget_bytes // 2
        got = _select_slab(bud, sel_end, kneed - sel_end, order, csum,
                           kk, m, n, a_rows, a_cols, b_rows, b_cols)
        if got is None:
            break
        sel, arow_panel, bj_panel = got
        if sel_end:
            # an extra level pays only when it removes more sort work
            # than its own transient build + popcount pass
            if (sel.covered < max(_MIN_LEVEL_COVER, 0.05 * rem)
                    and rem - sel.covered > _MIN_LEVEL_REM):
                break
        levels.append(_device_level(sel, arow_panel, bj_panel, A.device))
        sel_any[order[sel_end:sel_end + sel.kcut]] = True
        sel_end += sel.kcut
    if not levels:
        return None
    covered_all = int(csum[sel_end - 1])
    if covered_all < _MIN_COVER * total:
        return None

    lv0 = levels[0]
    Apack = _pack(lv0.na, lv0.W, lv0.a_rows, lv0.a_slots)
    Bpack = _pack(lv0.nb, lv0.W, lv0.b_js, lv0.b_slots)
    # drop the level-1 lists: one-shot counting never re-packs level 1,
    # and at scale the lists are O(nnz) of device memory
    z = torch.zeros(0, dtype=torch.int32, device=A.device)
    levels[0] = lv0._replace(a_rows=z, a_slots=z, b_js=z, b_slots=z)

    keep = np.zeros(A.nzmax, bool)
    keep[:A.nvals] = ~sel_any[a_cols]
    A_light = _shrink(csr_filter_lanes(A, torch.from_numpy(keep)))
    # hand the residual its host pattern (same order as the device
    # compaction) so the sort-merge engine can row-slice the mask
    lk = keep[:A.nvals]
    A_light._options["host_pattern"] = (a_rows[lk], a_cols[lk])
    return BitdotPlan(Apack, Bpack, A_light, levels[0].W, sel_end,
                      covered_all, total - covered_all, tuple(levels))


def _shrink(X: CsrMatrix) -> CsrMatrix:
    """Cut a compacted matrix's padded capacity down to its nnz bucket
    so downstream per-entry stages don't pay for the original size."""
    cap = _bucket(max(X.nvals, 8), 128)
    if cap >= X.nzmax:
        return X
    return CsrMatrix(X.indptr, X.indices[:cap], X.rowids[:cap],
                     X.values[:cap], X.nvals, X.nrows, X.ncols, X.type)


def _check_popcount_args(Apack, Bpack, amap, bmap, rowids, indices):
    dev = Apack.device
    for name, x, dim in (("Apack", Apack, 2), ("Bpack", Bpack, 2),
                         ("amap", amap, 1), ("bmap", bmap, 1),
                         ("rowids", rowids, 1), ("indices", indices, 1)):
        if x is None and name.endswith("map"):
            continue
        if x.dtype != torch.int32 or x.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D int32 tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.numel() == 0:
            raise ValueError(f"{name} is empty")
    if Apack.shape[1] != Bpack.shape[1]:
        raise ValueError(f"panel widths differ: {Apack.shape[1]} vs "
                         f"{Bpack.shape[1]}")
    if rowids.shape != indices.shape:
        raise ValueError("rowids and indices differ in length")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _bitdot_popcount_plain(Apack, Bpack, amap, bmap, rowids, indices,
                           nvals: int) -> torch.Tensor:
    """Plain version of the popcount kernel: index gather, AND, SWAR
    popcount, sum over the words, in chunks of entries."""
    E = rowids.shape[0]
    live = torch.arange(E, device=rowids.device) < nvals
    ii = torch.where(live, rowids, 0).long()
    jj = torch.where(live, indices, 0).long()
    if amap is not None:
        ii = amap[ii.clamp(0, amap.shape[0] - 1)].long()
    if bmap is not None:
        jj = bmap[jj.clamp(0, bmap.shape[0] - 1)].long()
    ok = (ii >= 0) & (jj >= 0) & live
    ii = ii.clamp(0, Apack.shape[0] - 1)
    jj = jj.clamp(0, Bpack.shape[0] - 1)
    out = torch.empty(E, dtype=torch.int32, device=rowids.device)
    step = max(1, _CHUNK_WORDS // Apack.shape[1])
    for s in range(0, E, step):
        x = Apack[ii[s:s + step]] & Bpack[jj[s:s + step]]
        out[s:s + step] = popcount(x).sum(1, dtype=torch.int32)
    return torch.where(ok, out, 0)


def bitdot_popcount(Apack: torch.Tensor, Bpack: torch.Tensor,
                    amap: Optional[torch.Tensor],
                    bmap: Optional[torch.Tensor], rowids: torch.Tensor,
                    indices: torch.Tensor, nvals: int) -> torch.Tensor:
    """counts[e] = sum_w popc(Apack[amap[rowids[e]], w] &
    Bpack[bmap[indices[e]], w]) for e < nvals, with 0 past nvals and
    where a map gives -1 (an absent map is the identity).  Returns
    (len(rowids),) int32.  CUDA tensors launch the popcount kernel;
    CPU tensors run its plain version."""
    dev = _check_popcount_args(Apack, Bpack, amap, bmap, rowids, indices)
    if dev.type == "cpu":
        return _bitdot_popcount_plain(Apack, Bpack, amap, bmap, rowids,
                                      indices, nvals)
    E = rowids.shape[0]
    out = torch.empty(E, dtype=torch.int32, device=dev)
    _build.launch(
        "bitdot_popcount", Apack,
        Apack.data_ptr(), Bpack.data_ptr(),
        None if amap is None else amap.data_ptr(),
        None if bmap is None else bmap.data_ptr(),
        rowids.data_ptr(), indices.data_ptr(), out.data_ptr(),
        E, min(int(nvals), E), Apack.shape[0], Bpack.shape[0],
        Apack.shape[1], 0 if amap is None else amap.shape[0],
        0 if bmap is None else bmap.shape[0])
    return out


def _bitdot_pass(Apack, Bpack, amap, bmap, M: CsrMatrix) -> torch.Tensor:
    """One gather+AND+popcount pass of a packed slab pair over M."""
    return bitdot_popcount(Apack, Bpack, amap, bmap, M.rowids, M.indices,
                           M.nvals)


def bitdot_counts(plan: BitdotPlan, M: CsrMatrix) -> torch.Tensor:
    """Heavy-slab counts per M padded entry: the cached level-1 panels
    plus one transient pack + pass per extra slab (each transient pair
    is freed when the next level packs, so peak memory is one extra
    pair)."""
    counts = None
    for li, lv in enumerate(plan.levels):
        if li == 0:
            Ap, Bp = plan.Apack, plan.Bpack
        else:
            Ap = _pack(lv.na, lv.W, lv.a_rows, lv.a_slots)
            Bp = _pack(lv.nb, lv.W, lv.b_js, lv.b_slots)
        c = _bitdot_pass(Ap, Bp, lv.amap, lv.bmap, M)
        counts = c if counts is None else counts + c
    return counts


_NO_PLAN = object()   # cached "don't pack" decision


def _auto_budget(device: torch.device) -> int:
    """Panel budget bounded by what the device has free: a fixed budget
    runs out of memory when containers and workspace already hold
    several GB.  The static budget on the CPU."""
    if device.type != "cuda":
        return _PANEL_BUDGET
    free, _ = torch.cuda.mem_get_info(device)
    # leave room for the sort-merge workspace and the popcount pass
    return max(min(_PANEL_BUDGET, int(free * 0.5)), 1 << 28)


def _cached_plan(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                 budget_bytes: Optional[int] = None
                 ) -> Optional[BitdotPlan]:
    """Per-(M, A, B) pattern plan cache, stored on M: the panels depend
    only on the operand patterns, so repeated calls skip the host
    selection and the pack scatters."""
    entry = M._options.get("bitdot_plan")
    if entry is not None:
        ra, rb, plan = entry
        if ra() is A.indices and rb() is B.indices:
            return None if plan is _NO_PLAN else plan
    if budget_bytes is None:
        budget_bytes = _auto_budget(M.device)
    plan = build_bitdot_plan(M, A, B, budget_bytes=budget_bytes)
    M._options["bitdot_plan"] = (weakref.ref(A.indices),
                                 weakref.ref(B.indices),
                                 _NO_PLAN if plan is None else plan)
    return plan


def masked_pair_counts_auto(M: CsrMatrix, A: CsrMatrix, B: CsrMatrix,
                            chunk: Optional[int] = None,
                            budget_bytes: Optional[int] = None
                            ) -> torch.Tensor:
    """counts[e] = (A.B)[i_e, j_e] over PLUS_PAIR, with automatic
    heavy/light splitting: bitmaps for the heavy wedge-middle columns,
    sort-merge for the residual.  Falls back to the pure sort-merge
    engine when the bitmaps can't pay (small graphs, flat wedge
    profiles).  Engine names: ``tri:sort_merge``, ``bitdot:full``,
    ``bitdot:hybrid`` (as in the JAX package)."""
    kw = {} if chunk is None else {"chunk": chunk}
    plan = _cached_plan(M, A, B, budget_bytes)
    if plan is None:
        counts = masked_pair_counts(M, A, B, **kw)
        record_axb_method("tri:sort_merge")
        return counts
    heavy = bitdot_counts(plan, M)
    if plan.light_lanes == 0 or plan.A_light.nvals == 0:
        record_axb_method("bitdot:full")
        return heavy
    light = masked_pair_counts(M, plan.A_light, B, **kw)
    record_axb_method("bitdot:hybrid")
    return heavy + light
