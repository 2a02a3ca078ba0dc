"""Fused window-panel masked counts: hand-written CUDA kernels.

Counterpart of ``graphblas_tpu/sparse/pallas_window.py``: the Pallas TPU
kernels become CUDA C++ kernels for Hopper (``csrc/window.cu``), built
with ``nvcc`` on first use and called through ctypes on PyTorch's
current stream.

Each wrapper takes the plan's int8 panels and returns per-block-row
int32 partials; the caller sums them in int64.  On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the kernel's
plain PyTorch version, defined here beside it.

Engine names (``last_axb_method``), port <-> JAX package:

    cuda:tri_band_ring / torch:tri_band_ring  <->  pallas:tri_band_ring
    cuda:window_count  / torch:window_count   <->  pallas:window_count

The unreduced masked product (``window_masked_mm_pallas``) is still to
be ported.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops.flopcount import record_axb_method
from .window import T, BandPlan, WindowPlan

__all__ = ["tricount_band_partials", "window_count_partials"]


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


def tricount_band_partials(plan: BandPlan) -> torch.Tensor:
    """Per-block-row triangle partials (nI,) int32 of a band plan; the
    triangle count is their int64 sum.  The mask is the P panel itself
    (the SandiaDot mask L is the left operand)."""
    P, Ut = plan.P, plan.Ut
    dev = _check_panels(("P", P), ("Ut", Ut))
    nI, rows, W = P.shape
    if rows != T or W % T or tuple(Ut.shape) != (nI, W, T):
        raise ValueError(f"band panels P {tuple(P.shape)} and Ut "
                         f"{tuple(Ut.shape)} do not form a band plan")
    if dev.type == "cpu":
        record_axb_method("torch:tri_band_ring")
        return _tri_band_partials_plain(P, Ut)
    out = torch.zeros(nI, dtype=torch.int32, device=dev)
    _build.launch("tri_band_ring", P, P.data_ptr(), Ut.data_ptr(),
                  out.data_ptr(), nI, W // T)
    record_axb_method("cuda:tri_band_ring")
    return out


def _window_count_plain(P: torch.Tensor, Q: torch.Tensor,
                        M: torch.Tensor) -> torch.Tensor:
    """Plain version of the window-count kernel: per block-row i,
    sum((P[i] @ Q[i]) * M[i]) as int32 (the product in float64, exact at
    these sums)."""
    C = torch.bmm(P.double(), Q.double())
    return (C * M).sum((1, 2)).to(torch.int32)


def window_count_partials(plan: WindowPlan) -> torch.Tensor:
    """Per-block-row masked-count partials (nI,) int32 of a window plan.
    Each partial is bounded by 128 * (16*128)^2 < 2^31, so int32 is safe;
    callers take the total in int64."""
    P, Q, M = plan.P, plan.Q, plan.M
    dev = _check_panels(("P", P), ("Q", Q), ("M", M))
    nI, rows, W = P.shape
    nJ = M.shape[2]
    if (rows != T or W % T or nJ % T or tuple(Q.shape) != (nI, W, nJ)
            or tuple(M.shape) != (nI, T, nJ)):
        raise ValueError(f"window panels P {tuple(P.shape)}, Q "
                         f"{tuple(Q.shape)}, M {tuple(M.shape)} do not "
                         f"form a window plan")
    if dev.type == "cpu":
        record_axb_method("torch:window_count")
        return _window_count_plain(P, Q, M)
    out = torch.zeros(nI, dtype=torch.int32, device=dev)
    _build.launch("window_count", P, P.data_ptr(), Q.data_ptr(),
                  M.data_ptr(), out.data_ptr(), nI, W, nJ)
    record_axb_method("cuda:window_count")
    return out
