"""Window- and band-panel plans for masked SpGEMM on banded graphs.

Counterpart of ``graphblas_tpu/sparse/window.py``.  Each 128-row block I
of A touches a narrow contiguous window of columns, and the masked
output blocks sit in a narrow window too, so the masked product
collapses to one batched dense int8 contraction per block-row:

    C_I = P_I @ Q_I        (P_I = A[I-rows, window], Q_I = B' panels)

times the mask panel M_I.  The panels are built on the host in numpy
from the CSR host pattern, exactly as the JAX package builds them, and
then moved to the device of the operands.  ``build_window_plan`` and
``build_band_plan`` return None when the structure is too wide to pay
(power-law graphs); callers then fall back to the counting engines.

The per-block partial sums are computed by the kernels of
:mod:`cuda_window`; :func:`window_masked_count_sum` is the plain
PyTorch product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.flopcount import record_axb_method

__all__ = ["WindowPlan", "BandPlan", "build_window_plan",
           "build_band_plan", "window_masked_count_sum", "tricount_window"]

T = 128

#: reject plans whose contraction window exceeds this many 128-blocks —
#: wider windows mean the dense panels are mostly padding
MAX_W_BLOCKS = 16
#: panel memory budget (bytes) for P+Q+M on device
MAX_PANEL_BYTES = 1 << 31


class WindowPlan:
    """Device panels + metadata for the batched window product."""

    def __init__(self, P, Q, M, nI, Wmax, nJmax, k0, j0, ntriples,
                 shape, mshape):
        self.P = P            # (nI, T, Wmax*T) int8
        self.Q = Q            # (nI, Wmax*T, nJmax*T) int8, B' panels
        self.M = M            # (nI, T, nJmax*T) int8
        self.nI = nI
        self.Wmax = Wmax
        self.nJmax = nJmax
        self.k0 = k0          # (nI,) window start block per I (host)
        self.j0 = j0          # (nI,) output block start per I (host)
        self.ntriples = ntriples   # real tile-triple count (flop truth)
        self.shape = shape
        self.mshape = mshape

    @property
    def panel_bytes(self):
        return sum(x.numel() * x.element_size()
                   for x in (self.P, self.Q, self.M))


def _block_panels(rows, cols, nrows, lo, hi, width, starts, dtype,
                  vals=None):
    """Scatter COO entries into per-block dense panels.

    rows/cols: COO (sorted by row); for block b (0-based over
    ``len(lo)`` blocks), rows in [lo[b], hi[b]) land in panel b at
    local (row - lo[b], col - starts[b]) when the col is inside
    [starts[b], starts[b]+width).  Returns (nb, maxrows, width)."""
    nb = len(lo)
    maxrows = int((hi - lo).max()) if nb else 0
    out = np.zeros((nb, maxrows, width), dtype)
    # entries may belong to several overlapping blocks -> loop blocks,
    # slice by row range (rows sorted, searchsorted)
    r0 = np.searchsorted(rows, lo)
    r1 = np.searchsorted(rows, hi - 1, side="right")
    for b in range(nb):
        s, e = r0[b], r1[b]
        if s == e:
            continue
        lr = rows[s:e] - lo[b]
        lc = cols[s:e] - starts[b]
        keep = (lc >= 0) & (lc < width)
        if vals is None:
            out[b, lr[keep], lc[keep]] = 1
        else:
            out[b, lr[keep], lc[keep]] = vals[s:e][keep]
    return out


#: set bits per byte value
_POPC8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                       axis=1).sum(1)


def _tile_triples(occA, occB, occM) -> int:
    """Real tile-triple count: sum over occupied mask tiles (I, J) of
    the number of K with A tile (I, K) and B tile (J, K) occupied.
    Works on bit-packed occupancy rows over occM's nonzeros only (the
    JAX package's dense three-way einsum costs nI^2 * nK operations,
    which dominates plan building once nI reaches thousands)."""
    pa, pb = np.packbits(occA, axis=1), np.packbits(occB, axis=1)
    ii, jj = np.nonzero(occM)
    step = max(1, (1 << 24) // max(pa.shape[1], 1))
    return sum(int(_POPC8[pa[ii[s:s + step]] & pb[jj[s:s + step]]].sum())
               for s in range(0, len(ii), step))


def _host_coo(X) -> Optional[Tuple[np.ndarray, np.ndarray, int, int]]:
    """(rows, cols, nrows, ncols) host pattern of a CsrMatrix, in row
    order, or None when unavailable without a device copy."""
    hp = X._options.get("host_pattern")
    if hp is None:
        return None
    rows, cols = hp
    rows = np.asarray(rows[:X.nvals])
    cols = np.asarray(cols[:X.nvals])
    if len(rows) > 1 and not (rows[:-1] <= rows[1:]).all():
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
    return rows, cols, X.nrows, X.ncols


def build_window_plan(A, B, M) -> Optional[WindowPlan]:
    """Host-side plan for C<M> = A · B^T on CsrMatrix patterns (B given
    in ROW form: Q panels take B's rows).  Returns a WindowPlan on A's
    device, or None when the window structure doesn't pay.  Cached on
    A._options keyed by the operand identities."""
    key = ("_window_plan", id(B), id(M))
    plan = A._options.get(key)
    if plan is not None:
        return plan if isinstance(plan, WindowPlan) else None
    hA, hB, hM = _host_coo(A), _host_coo(B), _host_coo(M)
    if hA is None or hB is None or hM is None:
        return None
    ra, ca, m, k = hA
    rb, cb, nB, kB = hB
    rm, cm, mM, nM = hM
    nI = -(-m // T)
    nKb = -(-k // T)
    # per-block-row column window of A
    ba = ra // T
    k0 = np.full(nI, 0, np.int64)
    kw = np.zeros(nI, np.int64)
    first = np.searchsorted(ba, np.arange(nI))
    last = np.searchsorted(ba, np.arange(nI), side="right")
    for I in range(nI):
        if first[I] == last[I]:
            continue
        cs = ca[first[I]:last[I]]
        b0, b1 = cs.min() // T, cs.max() // T + 1
        k0[I] = b0
        kw[I] = b1 - b0
    # per-block-row output window of M
    bm = rm // T
    j0 = np.zeros(nI, np.int64)
    jw = np.zeros(nI, np.int64)
    firstm = np.searchsorted(bm, np.arange(nI))
    lastm = np.searchsorted(bm, np.arange(nI), side="right")
    for I in range(nI):
        if firstm[I] == lastm[I]:
            continue
        cs = cm[firstm[I]:lastm[I]]
        b0, b1 = cs.min() // T, cs.max() // T + 1
        j0[I] = b0
        jw[I] = b1 - b0
    Wmax = int(kw.max()) if nI else 0
    nJmax = int(jw.max()) if nI else 0
    ok = (Wmax and nJmax and Wmax <= MAX_W_BLOCKS
          and nJmax <= MAX_W_BLOCKS)
    if ok:
        pb = (nI * T * Wmax * T + nI * nJmax * T * Wmax * T
              + nI * T * nJmax * T)
        ok = pb <= MAX_PANEL_BYTES
    if not ok:
        A._options[key] = False
        return None
    dt = np.int8
    # P panels: A block-rows [I*T, (I+1)*T) over their windows
    P = _block_panels(ra, ca, m, np.arange(nI) * T, np.arange(nI) * T + T,
                      Wmax * T, k0 * T, dt)
    # Q panels: B rows [j0*T, (j0+nJmax)*T) over A's window cols, stored
    # TRANSPOSED (window, rows) so the contraction is a plain P @ Q
    Q = _block_panels(rb, cb, nB, j0 * T, j0 * T + nJmax * T,
                      Wmax * T, k0 * T, dt).transpose(0, 2, 1).copy()
    # M panels: mask block-rows over output cols [j0*T, (j0+nJmax)*T)
    Mm = _block_panels(rm, cm, mM, np.arange(nI) * T,
                       np.arange(nI) * T + T, nJmax * T, j0 * T, np.int8)
    # real tile-triple count for honest device-flop accounting
    occA = np.zeros((nI, nKb), bool)
    occA[ba, ca // T] = True
    occB = np.zeros((-(-nB // T), nKb), bool)
    occB[rb // T, cb // T] = True
    occM = np.zeros((nI, -(-nM // T)), bool)
    occM[bm, cm // T] = True
    ntr = _tile_triples(occA, occB, occM)
    dev = A.device
    plan = WindowPlan(torch.from_numpy(P).to(dev),
                      torch.from_numpy(Q).to(dev),
                      torch.from_numpy(Mm).to(dev),
                      nI, Wmax, nJmax, k0, j0, ntr, (m, k), (mM, nM))
    A._options[key] = plan
    return plan


def window_masked_count_sum(plan: WindowPlan) -> torch.Tensor:
    """Sum over mask entries of the structural product, as a 0-d int64
    tensor (the SandiaDot triangle count when A=L, B=U, M=L), computed
    by the plain PyTorch product."""
    from .cuda_window import _window_count_plain
    record_axb_method("window:count_sum")
    return _window_count_plain(plan.P, plan.Q, plan.M).sum(
        dtype=torch.int64)


def tricount_window(L, U) -> Optional[int]:
    """SandiaDot triangle count via the window engine: ntri =
    sum over L of (L · U')(i,j).  Returns None when the plan rejects
    the structure."""
    plan = build_window_plan(L, U, L)
    if plan is None:
        return None
    return int(window_masked_count_sum(plan))


# ---------------------------------------------------------------------------
# Band plan: uniform per-block windows for the band-ring kernel
# ---------------------------------------------------------------------------

class BandPlan:
    """Uniform-window band panels for the tricount band-ring kernel.

    P  (nI, 128, Wb*128)  int8: L row-block I over blocks [I-Wb+1, I+1)
    Ut (nI, Wb*128, 128)  int8: U row-block J, TRANSPOSED (window, rows),
                                over blocks [J, J+Wb)
    Uniform windows make every (I, J=I-s) pair's contraction overlap a
    fixed slice of s+1 blocks."""

    def __init__(self, P, Ut, nI, Wb, ntriples, nedges):
        self.P = P
        self.Ut = Ut
        self.nI = nI
        self.Wb = Wb
        self.ntriples = ntriples
        self.nedges = nedges

    @property
    def panel_bytes(self):
        return sum(x.numel() * x.element_size() for x in (self.P, self.Ut))


def build_band_plan(L, U) -> Optional[BandPlan]:
    """Tricount band plan: C<L> = L · U' for lower/upper-triangular
    pattern pairs whose band fits MAX_W_BLOCKS 128-blocks, on L's
    device.  Returns None (cached) when the structure doesn't qualify."""
    key = ("_band_plan", id(U))
    plan = L._options.get(key)
    if plan is not None:
        return plan if isinstance(plan, BandPlan) else None
    hL, hU = _host_coo(L), _host_coo(U)
    if hL is None or hU is None:
        return None
    rl, cl, m, _ = hL
    ru, cu, mu, _ = hU
    nI = -(-m // T)
    bl, bu = rl // T, ru // T
    # band width in blocks, both directions
    wb = 1
    if len(rl):
        wb = max(wb, int((bl - cl // T).max()) + 1)
    if len(ru):
        wb = max(wb, int((cu // T - bu).max()) + 1)
    if wb > MAX_W_BLOCKS or (cl > rl).any() or (cu < ru).any():
        L._options[key] = False
        return None
    pb = 2 * nI * T * wb * T
    if pb > MAX_PANEL_BYTES:
        L._options[key] = False
        return None
    lo = np.arange(nI) * T
    P = _block_panels(rl, cl, m, lo, lo + T, wb * T,
                      (np.arange(nI) - wb + 1) * T, np.int8)
    Ut = _block_panels(ru, cu, mu, lo, lo + T, wb * T,
                       np.arange(nI) * T, np.int8).transpose(0, 2, 1).copy()
    # real tile-triple count (device-flop truth, as in build_window_plan)
    nKb = -(-max(m, mu) // T)
    occL = np.zeros((nI, nKb), bool)
    occL[bl, cl // T] = True
    occU = np.zeros((nI, nKb), bool)
    occU[bu, cu // T] = True
    ntr = _tile_triples(occL, occU, occL)
    dev = L.device
    plan = BandPlan(torch.from_numpy(P).to(dev), torch.from_numpy(Ut).to(dev),
                    nI, wb, ntr, len(rl))
    L._options[key] = plan
    return plan
