"""Flop counting, AxB method selection and engine attribution.

Counterpart of ``graphblas_tpu/ops/flopcount.py``.  Reference:
``GB_AxB_flopcount.c`` (per-column flops of C<M>=A*B) and
``GB_AxB_select.c`` (the engine heuristic).  The candidate engines and
the throughputs that rank them are the JAX package's, so the port picks
the same engine for the same shapes (the parity tests compare like with
like); re-measuring them on the card is queued in ROADMAP.md.

Engine names match the JAX package's, except where a kernel replaces a
Pallas kernel: the JAX name ``pallas:<engine>`` becomes ``cuda:<engine>``
when the hand-written CUDA kernel ran and ``torch:<engine>`` when its
plain PyTorch version ran (a CPU tensor).  :func:`jax_engine_name` maps a
port name back to the JAX package's name.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import counters

__all__ = ["axb_flopcount", "choose_axb_method", "csr_flopcount",
           "entry_lanes", "flop_blocks", "last_axb_method",
           "record_axb_method", "jax_engine_name"]

_LAST_METHOD = {"method": None}


def record_axb_method(method: str) -> None:
    _LAST_METHOD["method"] = method
    counters.record_method(method)


def last_axb_method() -> Optional[str]:
    """Engine used by the most recent product (AxB_method_used)."""
    return _LAST_METHOD["method"]


def jax_engine_name(method: str) -> str:
    """The JAX package's name for the engine the port recorded as
    ``method``: ``cuda:tri_band_ring`` and ``torch:tri_band_ring`` both
    map to ``pallas:tri_band_ring``; other names are shared."""
    route, sep, engine = method.partition(":")
    if sep and route in ("cuda", "torch"):
        return f"pallas:{engine}"
    return method


def axb_flopcount(A_pattern, B_pattern, M_pattern=None) -> int:
    """# of multiply-adds to compute C<M>=A*B on the sparse pattern
    (reference ``GB_AxB_flopcount.c``: sum_j sum_{k in B(:,j)}
    nnz(A(:,k)); the masked count only visits columns j where M(:,j) is
    nonempty).  Host numpy patterns."""
    Ap = np.asarray(A_pattern)
    Bp = np.asarray(B_pattern)
    acol = Ap.sum(axis=0).astype(np.int64)          # nnz(A(:,k))
    if M_pattern is not None:
        mcol = np.asarray(M_pattern).any(axis=0)
        Bp = Bp[:, mcol] if mcol.ndim == 1 else Bp
    return int((Bp.T.astype(np.int64) @ acol).sum())


def entry_lanes(A, B) -> torch.Tensor:
    """The lanes of the CSR product A·B per slot of A: B's row degree at
    the slot's column id (int64, on A's device), 0 on a padded slot.
    Their sum is the product's flop count (``GB_AxB_flopcount.c``);
    their cumulative sum places each entry's lanes and slices A into
    flop-balanced blocks (:func:`flop_blocks`)."""
    lanes = torch.zeros(A.nzmax, dtype=torch.int64, device=A.device)
    lanes[:A.nvals] = B.row_degrees().index_select(0, A.indices[:A.nvals])
    return lanes


def csr_flopcount(A, B) -> int:
    """The exact flop count of A·B over CSR operands, on their device:
    the sum of :func:`entry_lanes`, then one scalar read (``reads``, the
    span ``gb.read.flopcount``) and one ``flopcount.exact``.  The sum is
    int64, which the count needs: it passes 2^31 on a Kronecker graph
    of scale 20."""
    counters.count("flopcount.exact")
    return counters.host_read(entry_lanes(A, B).sum(), "flopcount")


def flop_blocks(csum: np.ndarray, cap: int) -> List[Tuple[int, int]]:
    """Contiguous A-entry blocks ``[s, e)`` at flop-balanced bounds (the
    slicing plan of ``GB_AxB_parallel.c:52-59``), from the host
    cumulative lane count ``csum`` of :func:`entry_lanes`: each block
    holds at most ``cap`` lanes, except a single entry with more, which
    is a block of its own.  The blocks end with the last lane."""
    nz = len(csum)
    total = int(csum[-1]) if nz else 0
    bounds = [0]
    prev = 0
    while bounds[-1] < nz and prev < total:
        s = bounds[-1]
        nxt = int(np.searchsorted(csum, prev + cap, side="right"))
        nxt = min(max(nxt, s + 1), nz)
        bounds.append(nxt)
        prev = int(csum[nxt - 1])
    return list(zip(bounds[:-1], bounds[1:]))


# the JAX package's cost model constants (ops/sec), not measured on
# this card: they rank the engines the same way in both packages
_DENSE_MACS_PER_S = 2.0e14
_TILE_MACS_PER_S = 1.8e14
_BITPACK_LANES_PER_S = 5.0e9
_GENERIC_OPS_PER_S = 5.0e11
_ESC_LANES_PER_S = 2.0e9

# a dense engine is only feasible when the bitmap operands and output
# stay small: 2^28 elements per dense array
_DENSE_LIMIT = 1 << 28


def choose_axb_method(m: int, k: int, n: int,
                      annz: int, bnnz: int,
                      mnnz: Optional[int] = None,
                      ntile_triples: Optional[int] = None,
                      mxu_capable: bool = True,
                      tile: int = 128,
                      est_flops: Optional[int] = None) -> str:
    """Pick the cheapest *feasible* engine by modeled device time
    (``GB_AxB_select.c:93-159`` analogue): "dense-mxu", "bsr",
    "bitpack", "esc" or "generic", as the JAX package names them.

    ``est_flops``: expected multiply count for the sparse ESC engine
    (exact flopcount or the annz*bnnz/k estimate); when given, the
    sparse CSR engine competes.  Dense engines are excluded outright
    when any of the three bitmaps would exceed ``_DENSE_LIMIT``."""
    if not mxu_capable:
        return "generic"
    dense_ok = max(m * k, k * n, m * n) <= _DENSE_LIMIT
    best, t_best = None, float("inf")
    if dense_ok:
        best, t_best = "dense-mxu", (m * k * n) / _DENSE_MACS_PER_S
        if ntile_triples is not None:
            t_bsr = (ntile_triples * tile ** 3) / _TILE_MACS_PER_S
            if t_bsr < t_best:
                best, t_best = "bsr", t_bsr
        if mnnz is not None:
            words = max(1, (n + 31) // 32)
            t_bitpack = (mnnz * words) / _BITPACK_LANES_PER_S
            if t_bitpack < t_best:
                best, t_best = "bitpack", t_bitpack
    if est_flops is None and not dense_ok:
        est_flops = max(1, (annz * bnnz) // max(k, 1))
    if est_flops is not None:
        lanes = max(est_flops, 1)
        t_esc = lanes * max(np.log2(lanes), 1) / _ESC_LANES_PER_S
        if t_esc < t_best:
            best, t_best = "esc", t_esc
    return best or "esc"
