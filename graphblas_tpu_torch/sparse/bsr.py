"""Block-sparse (BSR) tiles and the tile-triple masked count.

Counterpart of ``graphblas_tpu/sparse/bsr.py``.  A pattern is cut into
128x128 tiles and the empty ones are dropped; a masked product
C<M> = A ⊕.⊗ B' becomes a batch of tile products, one per (I, J, K) tile
triple where A(I, K), B(J, K) and the output mask M(I, J) are all
nonempty, followed by a segment sum over K.  Work scales with the
number of nonempty tile triples instead of n³.

A ``TilePattern``'s stacked ``tiles`` are a torch tensor on an explicit
device (the card by default, or the device of a tensor given to the
builders); its ``grid`` and ``index`` are numpy, as in the JAX package.
Triples come from joining the grids' nonempty tiles (:func:`tile_triples`),
never from a dense Tm x Tn x Tk cube.

:func:`bsr_masked_count` is the JAX package's engine outside Pallas: it
gathers the triples' tiles and takes their batched product, a plain
product as the JAX package left it to XLA.  Torch has no int8 ``bmm`` on
CUDA, so it runs in float16 there (a 0/1 tile dot is at most 128, exact
in float16) and in float32 on the CPU, chunked over triples.  The
hand-written kernel for the same product is K7 (:mod:`cuda_bsr`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.errors import DimensionMismatch
from .container import resolve_device

__all__ = ["tile_pattern", "tile_pattern_from_coo", "tile_matrix",
           "bsr_masked_count", "tricount_bsr", "TilePattern",
           "tile_triples", "tile_products", "TILE"]

TILE = 128

#: tile triples per batched product (float16: 32 KB of operands and a
#: 32 KB product per triple)
_TRIPLE_CHUNK = 1 << 13


class TilePattern:
    """BSR decomposition of a pattern or value matrix.

    tiles:   [ntiles, T, T] tensor (stacked nonempty tiles; int8 0/1 for a
             pattern, the value dtype for :func:`tile_matrix`)
    grid:    [Tm, Tn] bool numpy (which tiles are nonempty)
    index:   [Tm, Tn] int32 numpy (tile id, or 0 for empty — masked by grid)
    """

    def __init__(self, tiles, grid, index, shape, T=TILE):
        self.tiles = tiles
        self.grid = grid
        self.index = index
        self.shape = shape
        self.T = T

    @property
    def ntiles(self):
        return int(self.tiles.shape[0])


def _on_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` (numpy or tensor) as a ``dtype`` tensor: on ``device`` when
    given, else on a tensor's own device, else on the default device."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else torch.device(device)
        return x.to(dev, dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device), dtype)


def _cut(x: torch.Tensor, pattern: torch.Tensor, T: int):
    """(tiles, grid, index) of the nonempty TxT tiles of ``pattern``,
    taking their contents from ``x`` (same shape); tiles in row-major
    grid order."""
    m, n = pattern.shape
    Tm, Tn = -(-m // T), -(-n // T)
    dev = pattern.device

    def blocks(a):
        padded = torch.zeros((Tm * T, Tn * T), dtype=a.dtype, device=dev)
        padded[:m, :n] = a
        return padded.view(Tm, T, Tn, T).permute(0, 2, 1, 3)

    grid_t = blocks(pattern).reshape(Tm, Tn, T * T).any(dim=2)
    ids = torch.nonzero(grid_t)
    tiles = blocks(x)[ids[:, 0], ids[:, 1]].contiguous()
    grid = grid_t.cpu().numpy()
    index = np.zeros((Tm, Tn), np.int32)
    index[grid] = np.arange(len(ids), dtype=np.int32)
    return tiles, grid, index


def tile_pattern(pattern, T: int = TILE, device=None) -> TilePattern:
    """Cut an [m, n] bool pattern (numpy or tensor) into its nonempty
    TxT int8 tiles."""
    p = _on_device(pattern, torch.bool, device)
    tiles, grid, index = _cut(p, p, T)
    return TilePattern(tiles.to(torch.int8), grid, index, tuple(p.shape), T)


def tile_pattern_from_coo(I, J, shape, T: int = TILE,
                          device=None) -> TilePattern:
    """BSR decomposition straight from an edge list — no dense [m, n]
    intermediate.  Only nonempty tiles are materialized, on ``device``
    (the default device when None)."""
    I = np.asarray(I, np.int64)
    J = np.asarray(J, np.int64)
    m, n = shape
    Tm, Tn = -(-m // T), -(-n // T)
    tid = (I // T) * Tn + J // T
    uniq, slot = np.unique(tid, return_inverse=True)
    ntiles = len(uniq)
    # scatter each edge's (local row, local col) bit into its tile slot
    flat = (slot.reshape(-1) * T + I % T) * T + J % T
    dev = resolve_device(device)
    tiles = torch.zeros(ntiles * T * T, dtype=torch.int8, device=dev)
    tiles[torch.from_numpy(flat).to(dev)] = 1
    grid = np.zeros((Tm, Tn), bool)
    grid[uniq // Tn, uniq % Tn] = True
    index = np.zeros((Tm, Tn), np.int32)
    index[uniq // Tn, uniq % Tn] = np.arange(ntiles, dtype=np.int32)
    return TilePattern(tiles.view(ntiles, T, T), grid, index, (m, n), T)


def tile_matrix(values, pattern, T: int = TILE, dtype=np.float32,
                device=None) -> TilePattern:
    """Cut an [m, n] value matrix into its pattern-nonempty TxT value
    tiles of ``dtype`` (zeros at absent positions) — the BSR value form
    for general semirings."""
    p = _on_device(pattern, torch.bool, device)
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    v = _on_device(values, tdt, p.device)
    v = torch.where(p, v, torch.zeros((), dtype=tdt, device=p.device))
    tiles, grid, index = _cut(v, p, T)
    return TilePattern(tiles, grid, index, tuple(p.shape), T)


def tile_triples(gm: np.ndarray, ga: np.ndarray, gb: np.ndarray):
    """(I, J, K) of every tile triple with gm[I, J], ga[I, K] and
    gb[J, K], in lexicographic order, by joining the grids' nonempty
    tiles: each nonempty M tile (I, J) pairs with the nonempty tiles of
    row I of A's grid, and keeps the K that row J of B's grid holds."""
    if gm.shape != (ga.shape[0], gb.shape[0]) or ga.shape[1] != gb.shape[1]:
        raise DimensionMismatch(f"tile grids M {gm.shape}, A {ga.shape}, "
                                f"B {gb.shape} do not form C<M> = A.B'")
    oi, oj = np.nonzero(gm)
    ar, ak = np.nonzero(ga)
    a_start = np.searchsorted(ar, np.arange(ga.shape[0] + 1))
    deg = a_start[oi + 1] - a_start[oi]
    o = np.repeat(np.arange(len(oi)), deg)
    base = np.repeat(a_start[oi] - np.cumsum(deg) + deg, deg)
    K = ak[base + np.arange(len(o))] if len(o) else ak[:0]
    keep = gb[oj[o], K]
    return oi[o][keep], oj[o][keep], K[keep]


def tile_products(Atiles: torch.Tensor, Btiles: torch.Tensor, ta, tb, oid,
                  nout: int, dtype: torch.dtype, acc_dtype: torch.dtype,
                  chunk: int = _TRIPLE_CHUNK) -> torch.Tensor:
    """out[oid[t]] += A[ta[t]] @ B[tb[t]]^T over the triples t (int64
    index tensors): ``chunk`` triples' tiles gathered and multiplied in
    one ``dtype`` batched product, summed into (nout, T, T) of
    ``acc_dtype``."""
    T = Atiles.shape[1]
    out = torch.zeros((nout, T, T), dtype=acc_dtype, device=Atiles.device)
    for s in range(0, len(ta), chunk):
        a = Atiles[ta[s:s + chunk]].to(dtype)
        b = Btiles[tb[s:s + chunk]].to(dtype)
        out.index_add_(0, oid[s:s + chunk],
                       torch.bmm(a, b.transpose(1, 2)).to(acc_dtype))
    return out


def _product_counts(Atiles: torch.Tensor, Btiles: torch.Tensor, ta, tb,
                    oid, nout: int) -> torch.Tensor:
    """out[oid[t]] += A[ta[t]] @ B[tb[t]]^T over triples, int32; the
    batched product in float16 on CUDA, float32 on the CPU."""
    dt = torch.float16 if Atiles.device.type == "cuda" else torch.float32
    return tile_products(Atiles, Btiles, ta, tb, oid, nout, dt, torch.int32)


def bsr_masked_count(Mp: TilePattern, Ap: TilePattern, Bp: TilePattern
                     ) -> Tuple[torch.Tensor, np.ndarray]:
    """Ctiles[t] = (A · B')[tile t of M's nonempty grid], counting
    semiring (PLUS_LAND on 0/1).  Returns (Ctiles [nout,T,T] int32 on
    A's tiles' device, out tile coordinates [nout, 2])."""
    gm = Mp.grid
    outs = np.nonzero(gm)
    nout = len(outs[0])
    I, J, K = tile_triples(gm, Ap.grid, Bp.grid)
    dev = Ap.tiles.device
    if len(I) == 0:
        T = Ap.T
        return (torch.zeros((nout, T, T), dtype=torch.int32, device=dev),
                np.stack(outs, 1))
    out_index = np.zeros(gm.shape, np.int64)
    out_index[outs] = np.arange(nout)

    def dev_idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    C = _product_counts(Ap.tiles, Bp.tiles, dev_idx(Ap.index[I, K]),
                        dev_idx(Bp.index[J, K]), dev_idx(out_index[I, J]),
                        nout)
    return C, np.stack(outs, 1)


def tricount_bsr(Lp, Up, T: int = TILE, device=None) -> int:
    """SandiaDot triangle count on the BSR path:
    ntri = sum((L · U') .* L) with batched tile products."""
    Lt = tile_pattern(Lp, T, device)
    Ut = tile_pattern(Up, T, device)
    C, outs = bsr_masked_count(Lt, Lt, Ut)
    # mask tiles = L's nonempty tiles in the same order as C
    Mtiles = Lt.tiles[torch.from_numpy(
        Lt.index[outs[:, 0], outs[:, 1]].astype(np.int64)).to(C.device)]
    return int(torch.where(Mtiles != 0, C, 0).sum(dtype=torch.int64))
