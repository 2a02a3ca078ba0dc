"""Fused window-panel masked products: hand-written CUDA kernels.

Counterpart of ``graphblas_tpu/sparse/pallas_window.py``: the Pallas TPU
kernels become CUDA C++ kernels for Hopper (``csrc/window.cu``), built
with ``nvcc`` on first use and called through ctypes on PyTorch's
current stream.

Each wrapper takes the plan's int8 panels and returns per-block-row
int32 partials (the caller sums them in int64) or, for
``window_masked_mm_pallas``, the masked int32 product panels.  All three
kernels run on the int8 tensor-core tile of ``csrc/mma_s8_tile.cuh``.
The band ring (K1) and the window count (K2) multiply only the tile
triples of the plan's :class:`~.window.TileSchedule` (its nonempty
128x128 tiles), which the wrapper builds at the first launch and the
plan keeps.  On a CUDA tensor a wrapper launches the kernel (or
raises); on a CPU tensor it runs the kernel's plain PyTorch version,
defined here beside it.  ``_tri_band_partials_scheduled`` and
``_window_count_scheduled`` are the plain versions over a schedule.

Engine names (``last_axb_method``), port <-> JAX package:

    cuda:tri_band_ring / torch:tri_band_ring  <->  pallas:tri_band_ring
    cuda:window_count  / torch:window_count   <->  pallas:window_count
    cuda:window_mm     / torch:window_mm      <->  pallas:window_mm
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops.flopcount import record_axb_method
from ..utils import counters
from .window import (T, BandPlan, TileSchedule, WindowPlan, band_schedule,
                     window_schedule)

__all__ = ["tricount_band_partials", "window_count_partials",
           "window_masked_mm_pallas"]

#: tile triples per batched product of the scheduled plain versions
_PLAIN_CHUNK = 1 << 10
#: k-blocks an output may take in the count kernels (one CUDA block's
#: threads stage the list)
_MAX_KBLOCKS = 256


def _check_panels(*named) -> torch.device:
    """Every panel int8, contiguous, 3-D, on one device; returns it."""
    dev = named[0][1].device
    for name, x in named:
        if x.dtype != torch.int8 or x.dim() != 3:
            raise TypeError(f"{name} must be a 3-D int8 tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _tri_band_partials_plain(P: torch.Tensor,
                             Ut: torch.Tensor) -> torch.Tensor:
    """Plain version of the band-ring kernel: for each block-row i and
    offset s with J = i - s >= 0, sum over (r, c) of
    P[i][r, jj*T+c] * (P[i][:, jj*T:jj*T+ov] @ Ut[J][:ov])[r, c], with
    jj = Wb-1-s and ov = (s+1)*T.  The product runs in float64, which is
    exact at these sums (torch has no integer matmul on CUDA)."""
    nI, _, W = P.shape
    Wb = W // T
    out = torch.zeros(nI, dtype=torch.int64, device=P.device)
    for s in range(min(Wb, nI)):
        jj = Wb - 1 - s
        ov = (s + 1) * T
        C = torch.bmm(P[s:, :, jj * T:jj * T + ov].double(),
                      Ut[:nI - s, :ov, :].double())
        msk = P[s:, :, jj * T:(jj + 1) * T]
        out[s:] += (C * msk).sum((1, 2)).long()
    return out.to(torch.int32)


def _triples(sched: TileSchedule):
    """(output row, output column, k-block) of each of a schedule's tile
    triples, int64."""
    counts = (sched.kptr[1:] - sched.kptr[:-1]).long()
    o = torch.repeat_interleave(
        torch.arange(sched.nout, device=counts.device), counts)
    return sched.rows.long()[o], sched.cols.long()[o], sched.kblk.long()


def _scheduled_sum(nI: int, i: torch.Tensor, tiles) -> torch.Tensor:
    """Partials (nI,) int32: per triple t, sum(A_t @ B_t * M_t) added to
    row i[t], with ``tiles(sl)`` giving the (A, B, M) tile stacks of the
    triples ``sl``; products in float64, exact at these sums."""
    out = torch.zeros(nI, dtype=torch.int64, device=i.device)
    for c in range(0, i.numel(), _PLAIN_CHUNK):
        sl = slice(c, c + _PLAIN_CHUNK)
        A, B, Msk = tiles(sl)
        part = (torch.bmm(A.double(), B.double()) * Msk).sum((1, 2))
        out.index_add_(0, i[sl], part.long())
    return out.to(torch.int32)


def _tri_band_partials_scheduled(P: torch.Tensor, Ut: torch.Tensor,
                                 sched: TileSchedule) -> torch.Tensor:
    """Plain version of the band-ring kernel over its schedule: for each
    triple (output (i, s), k-block kb), sum(P[i] tile jj+kb @ Ut[i-s]
    tile kb * P[i] tile jj), jj = Wb-1-s, into partials[i].  Equal to
    :func:`_tri_band_partials_plain`: every tile product left out has an
    empty operand or mask tile."""
    nI, _, W = P.shape
    Wb = W // T
    P4, U4 = P.view(nI, T, Wb, T), Ut.view(nI, Wb, T, T)
    i, s, kb = _triples(sched)
    jj = Wb - 1 - s
    return _scheduled_sum(nI, i, lambda sl: (
        P4[i[sl], :, jj[sl] + kb[sl], :], U4[i[sl] - s[sl], kb[sl]],
        P4[i[sl], :, jj[sl], :]))


def _check_kblocks(nk: int):
    """Raise on panels of more k-blocks than the count kernels take."""
    if nk > _MAX_KBLOCKS:
        raise ValueError(f"the count kernels take at most {_MAX_KBLOCKS} "
                         f"k-blocks an output; the panels have {nk}")


def _check_aligned(*xs):
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("the window kernels read 16-byte aligned panels")


@counters.spanned("gb.engines.band_ring")
def tricount_band_partials(plan: BandPlan) -> torch.Tensor:
    """Per-block-row triangle partials (nI,) int32 of a band plan; the
    triangle count is their int64 sum.  The mask is the P panel itself
    (the SandiaDot mask L is the left operand).  On the card the kernel
    multiplies the tile triples of :func:`~.window.band_schedule`."""
    P, Ut = plan.P, plan.Ut
    dev = _check_panels(("P", P), ("Ut", Ut))
    nI, rows, W = P.shape
    if rows != T or W % T or tuple(Ut.shape) != (nI, W, T):
        raise ValueError(f"band panels P {tuple(P.shape)} and Ut "
                         f"{tuple(Ut.shape)} do not form a band plan")
    if dev.type == "cpu":
        record_axb_method("torch:tri_band_ring")
        return _tri_band_partials_plain(P, Ut)
    _check_kblocks(W // T)
    _check_aligned(P, Ut)
    sched = band_schedule(plan)
    out = torch.zeros(nI, dtype=torch.int32, device=dev)
    if sched.nout:
        _build.launch("tri_band_ring", P, P.data_ptr(), Ut.data_ptr(),
                      sched.rows.data_ptr(), sched.cols.data_ptr(),
                      sched.kptr.data_ptr(), sched.kblk.data_ptr(),
                      out.data_ptr(), sched.nout, W // T)
    record_axb_method("cuda:tri_band_ring")
    return out


def _window_mm_plain(P: torch.Tensor, Q: torch.Tensor,
                     M: torch.Tensor) -> torch.Tensor:
    """Plain version of the window-product kernel: (P[i] @ Q[i]) * M[i]
    per block-row as int32 (the product in float64, exact at these
    counts)."""
    return (torch.bmm(P.double(), Q.double()) * M).to(torch.int32)


def _window_count_plain(P: torch.Tensor, Q: torch.Tensor,
                        M: torch.Tensor) -> torch.Tensor:
    """Plain version of the window-count kernel: per block-row i,
    sum((P[i] @ Q[i]) * M[i]) as int32."""
    return _window_mm_plain(P, Q, M).sum((1, 2)).to(torch.int32)


def _window_count_scheduled(P: torch.Tensor, Q: torch.Tensor,
                            M: torch.Tensor,
                            sched: TileSchedule) -> torch.Tensor:
    """Plain version of the window-count kernel over its schedule: for
    each triple (output (i, c), k-block kb), sum(P[i] tile kb @ Q[i] tile
    (kb, c) * M[i] tile c) into partials[i].  Equal to
    :func:`_window_count_plain`."""
    nI, _, W = P.shape
    nJ = M.shape[2]
    P4 = P.view(nI, T, W // T, T)
    Q5 = Q.view(nI, W // T, T, nJ // T, T)
    M4 = M.view(nI, T, nJ // T, T)
    i, c, kb = _triples(sched)
    return _scheduled_sum(nI, i, lambda sl: (
        P4[i[sl], :, kb[sl], :], Q5[i[sl], kb[sl], :, c[sl], :],
        M4[i[sl], :, c[sl], :]))


def _check_window(plan: WindowPlan):
    """(P, Q, M, device) of a window plan whose panels fit together."""
    P, Q, M = plan.P, plan.Q, plan.M
    dev = _check_panels(("P", P), ("Q", Q), ("M", M))
    nI, rows, W = P.shape
    nJ = M.shape[2]
    if (rows != T or W % T or nJ % T or tuple(Q.shape) != (nI, W, nJ)
            or tuple(M.shape) != (nI, T, nJ)):
        raise ValueError(f"window panels P {tuple(P.shape)}, Q "
                         f"{tuple(Q.shape)}, M {tuple(M.shape)} do not "
                         f"form a window plan")
    return P, Q, M, dev


@counters.spanned("gb.engines.window_count")
def window_count_partials(plan: WindowPlan) -> torch.Tensor:
    """Per-block-row masked-count partials (nI,) int32 of a window plan.
    Each partial is bounded by 128 * (16*128)^2 < 2^31, so int32 is safe;
    callers take the total in int64.  On the card the kernel multiplies
    the tile triples of :func:`~.window.window_schedule`."""
    P, Q, M, dev = _check_window(plan)
    if dev.type == "cpu":
        record_axb_method("torch:window_count")
        return _window_count_plain(P, Q, M)
    nI, _, W = P.shape
    _check_kblocks(W // T)
    _check_aligned(P, Q, M)
    sched = window_schedule(plan)
    out = torch.zeros(nI, dtype=torch.int32, device=dev)
    if sched.nout:
        _build.launch("window_count", P, P.data_ptr(), Q.data_ptr(),
                      M.data_ptr(), sched.rows.data_ptr(),
                      sched.cols.data_ptr(), sched.kptr.data_ptr(),
                      sched.kblk.data_ptr(), out.data_ptr(), sched.nout, W,
                      M.shape[2])
    record_axb_method("cuda:window_count")
    return out


def window_masked_mm_pallas(plan: WindowPlan) -> torch.Tensor:
    """Masked count panels (nI, 128, nJmax*128) int32, (P[i] @ Q[i]) *
    M[i]: the general window engine's output, in the layout of
    :func:`window.window_masked_mm` (panel (I, r, c) is the global entry
    (I*128 + r, j0[I]*128 + c)).  The name is the JAX package's."""
    P, Q, M, dev = _check_window(plan)
    if dev.type == "cpu":
        record_axb_method("torch:window_mm")
        return _window_mm_plain(P, Q, M)
    nI, _, W = P.shape
    nJ = M.shape[2]
    _check_aligned(P, Q, M)
    out = torch.empty((nI, T, nJ), dtype=torch.int32, device=dev)
    _build.launch("window_mm", P, P.data_ptr(), Q.data_ptr(), M.data_ptr(),
                  out.data_ptr(), nI, W, nJ)
    record_axb_method("cuda:window_mm")
    return out
