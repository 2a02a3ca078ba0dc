"""Edge-centric masked SpGEMM on bit-packed patterns.

Counterpart of ``graphblas_tpu/sparse/spgemm.py``.  For counting
semirings a masked product C<M> = A ⊕.⊗ B only needs, per output edge
(i, j) ∈ M, the size of the intersection of A's row i with B's row j;
with rows packed 32 columns per word (:mod:`bitpack`) that is::

    count[e] = popcount( Arows[ei[e]] & Brows[ej[e]] )

— the popcount pass of :mod:`bitdot` with no row maps (the hand-written
kernel ``gb_bitdot_popcount`` on the card, its plain version on the
CPU).  ``tricount_sparse`` and ``ktruss_sparse`` run on it for a bitmap
``Matrix``; a ``CsrMatrix`` routes to the CSR engines of :mod:`tri`.

The JAX functions' ``chunk`` argument (entries per TPU step) is left
out: the kernel streams every entry in one launch, and its plain
version bounds its own working set.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..core.matrix import Matrix
from .bitdot import bitdot_popcount
from .bitpack import pack_pattern
from .container import CsrMatrix

__all__ = ["edge_intersection_counts", "tricount_sparse", "ktruss_sparse",
           "masked_spgemm_counts"]


def edge_intersection_counts(Arows: torch.Tensor, Brows: torch.Tensor, ei,
                             ej) -> torch.Tensor:
    """count[e] = |row ei[e] of A  ∩  row ej[e] of B| (packed int32
    rows), int32 on the rows' device."""
    dev = Arows.device

    def idx(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.int32)
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    ei, ej = idx(ei), idx(ej)
    if ei.numel() == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    return bitdot_popcount(Arows.contiguous(), Brows.contiguous(), None,
                           None, ei.contiguous(), ej.contiguous(),
                           ei.numel())


def masked_spgemm_counts(M_edges: Tuple[np.ndarray, np.ndarray],
                         A_pattern, B_pattern, device=None) -> torch.Tensor:
    """counts[e] = (A · B')[i,j] over the PLUS_LAND/PLUS_TIMES-on-0/1
    semiring for each masked edge (i, j); A_pattern/B_pattern are [., n]
    bool arrays (rows of B' = rows of B), packed on ``device`` (the card
    by default)."""
    ei, ej = M_edges
    return edge_intersection_counts(pack_pattern(A_pattern, device),
                                    pack_pattern(B_pattern, device), ei, ej)


def tricount_sparse(A: Union[Matrix, CsrMatrix]) -> int:
    """SandiaDot triangle count on the bitpacked path:
    ntri = Σ_{(i,j) ∈ L} |L_i ∩ U_j|.  A CsrMatrix routes to the masked
    CSR counter (:func:`tri.tricount_esc`), which never builds an n x n
    array."""
    if isinstance(A, CsrMatrix):
        from .tri import csr_tril, csr_triu, tricount_esc
        return tricount_esc(csr_tril(A), csr_triu(A))
    Ap = A.wait().pattern_np()
    Lp = np.tril(Ap, -1)
    Up = np.triu(Ap, 1)
    ei, ej = np.nonzero(Lp)
    if len(ei) == 0:
        return 0
    counts = masked_spgemm_counts((ei, ej), Lp, Up, A.device)
    return int(counts.sum(dtype=torch.int64))


def ktruss_sparse(A: Union[Matrix, CsrMatrix], k: int):
    """Sparse k-truss: per-edge support by row intersection, prune,
    repeat until stable.  Returns ((I, J, support) host arrays, nsteps).
    A CsrMatrix routes to :func:`tri.ktruss_esc`."""
    if k < 3:
        raise ValueError("k must be >= 3")
    if isinstance(A, CsrMatrix):
        from .tri import ktruss_esc
        truss, counts, nsteps = ktruss_esc(A, k)
        I, J, _ = truss.extractTuples()
        supp = counts[:truss.nvals].cpu().numpy().astype(np.int32)
        return (I, J, supp), nsteps
    Ap = A.wait().pattern_np().copy()
    dev = A.device
    support = k - 2
    nsteps = 0
    last_ne = Ap.sum()
    while True:
        nsteps += 1
        ei, ej = np.nonzero(Ap)
        if len(ei) == 0:
            return (ei, ej, np.zeros(0, np.int32)), nsteps
        # support[e] = |N(i) ∩ N(j)| within the current truss
        packed = pack_pattern(Ap, dev)
        counts = edge_intersection_counts(packed, packed, ei,
                                          ej).cpu().numpy()
        keep = counts >= support
        ne = int(keep.sum())
        if ne == last_ne:
            return (ei, ej, counts), nsteps
        Ap = np.zeros_like(Ap)
        Ap[ei[keep], ej[keep]] = True
        last_ne = ne
