"""BSR SpMV, y = A (+.x) x on dense 128x128 f32 tiles: a hand-written
CUDA kernel (K5).

Counterpart of ``graphblas_tpu/sparse/pallas_spmv.py``: the Pallas TPU
kernel becomes ``csrc/spmv.cu`` (``gb_bsr_spmv``), built with ``nvcc``
on first use and called through ctypes on PyTorch's current stream.

The plan (:func:`bsr_spmv_plan`) has the JAX package's array layout, so
the tests compare ``rb, cb, slot, valid, tiles`` one to one: the
occupied tiles in (row-block, col-block) order, duplicates summed, one
invalid dummy triple per empty row-block; it adds ``rbptr``, the first
triple of each row-block, which gives each row-block one owner on the
card (the TPU relied on its sequential grid instead).

:func:`bsr_spmv_ok` is the JAX package's gate with its constants
(``MIN_NNZ_PER_TILE``, ``MAX_TILE_BYTES``: a TPU cost model, kept so
both packages choose the same engine); its CPU-backend test becomes "A
is on the CPU".  On a CUDA tensor :func:`bsr_spmv_tiles` launches the
kernel (or raises); on a CPU tensor it runs the kernel's plain PyTorch
version.

Engine names (``last_axb_method``), port <-> JAX package:

    cuda:bsr_spmv / torch:bsr_spmv  <->  pallas:bsr_spmv
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core.semirings import Semiring
from ..ops.flopcount import record_axb_method
from .container import CsrMatrix

__all__ = ["TILE", "MIN_NNZ_PER_TILE", "MAX_TILE_BYTES", "BsrSpmvPlan",
           "bsr_spmv_plan", "bsr_spmv_ok", "bsr_spmv", "bsr_spmv_tiles"]

#: tile edge (the JAX package's ``sparse/bsr.py`` TILE)
TILE = 128
#: the engine pays one tile read per ~this many lanes to break even with
#: the one-gather engine (the JAX package's TPU calibration)
MIN_NNZ_PER_TILE = 8
#: cap on materialized tile bytes (f32): a memory guard
MAX_TILE_BYTES = 2 << 30


class BsrSpmvPlan(NamedTuple):
    """Triples ``(rb, cb, slot, valid)`` sorted by row-block, the value
    ``tiles`` (ntiles, T, T), the grid ``nrb`` x ``ncb``, ``ntiles``, and
    ``rbptr`` (nrb + 1,): row-block r owns triples rbptr[r]:rbptr[r+1]."""
    rb: torch.Tensor
    cb: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor
    tiles: torch.Tensor
    nrb: int
    ncb: int
    ntiles: int
    rbptr: torch.Tensor


def _host_rows_cols(A: CsrMatrix):
    host_pat = A._options.get("host_pattern")
    if host_pat is not None:
        return host_pat
    return A.rowids.cpu().numpy(), A.indices.cpu().numpy()


def bsr_spmv_plan(A: CsrMatrix, T: int = TILE,
                  dtype=np.float32) -> BsrSpmvPlan:
    """Host-side once-per-matrix BSR decomposition (cached on the
    container): value tiles straight from the CSR tuples (no dense
    [m, n] intermediate; duplicates sum through ``np.add.at``) and the
    row-block-sorted triple schedule with one invalid dummy triple per
    empty row-block."""
    key = ("_bsr_spmv_plan", T, np.dtype(dtype).str)
    plan = A._options.get(key)
    if plan is not None:
        return plan
    rows, cols = _host_rows_cols(A)
    live = rows < A.nrows                    # drop padded lanes
    rows, cols = rows[live], cols[live]
    vals = A.values.cpu().numpy()
    if A.type.is_unsigned:
        vals = vals.view(A.type.dtype)
    vals = vals[: len(live)][live]
    m, n = A.nrows, A.ncols
    nrb, ncb = -(-m // T), -(-n // T)
    tid = (rows // T).astype(np.int64) * ncb + cols // T
    order = np.argsort(tid, kind="stable")
    tid_s = tid[order]
    # slot lookup by searchsorted on the sorted tile ids: O(nnz log
    # ntiles) and independent of the grid's size
    uniq = np.unique(tid_s)
    ntiles = len(uniq)
    tiles = np.zeros((ntiles, T, T), dtype)
    slot_s = np.searchsorted(uniq, tid_s)
    np.add.at(tiles, (slot_s, (rows % T)[order], (cols % T)[order]),
              vals[order].astype(dtype))
    rb = (uniq // ncb).astype(np.int32)
    cb = (uniq % ncb).astype(np.int32)
    slot = np.arange(ntiles, dtype=np.int32)
    valid = np.ones(ntiles, np.int32)
    empty_rb = np.setdiff1d(np.arange(nrb, dtype=np.int32), rb)
    if len(empty_rb):
        rb = np.concatenate([rb, empty_rb])
        cb = np.concatenate([cb, np.zeros(len(empty_rb), np.int32)])
        slot = np.concatenate([slot, np.zeros(len(empty_rb), np.int32)])
        valid = np.concatenate([valid, np.zeros(len(empty_rb), np.int32)])
        reorder = np.argsort(rb, kind="stable")
        rb, cb, slot, valid = (rb[reorder], cb[reorder], slot[reorder],
                               valid[reorder])
    rbptr = np.searchsorted(rb, np.arange(nrb + 1)).astype(np.int32)
    dev = A.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    plan = BsrSpmvPlan(put(rb), put(cb), put(slot), put(valid), put(tiles),
                       nrb, ncb, ntiles, put(rbptr))
    A._options[key] = plan
    return plan


def bsr_spmv_ok(sr: Semiring, A: CsrMatrix, T: int = TILE) -> bool:
    """The flop-model gate: f32 PLUS_TIMES, tiles dense enough to beat
    the one-gather engine, tile bytes within budget.

    ``A._options["bsr_spmv"]`` is a per-matrix tri-state: False opts out
    (dense tiles give 0*inf = NaN for rows sharing a column block with a
    non-finite x entry, where the gather engines give nothing), True
    forces past the device test (tests), None is automatic: a matrix on
    the CPU never takes the tile engine."""
    if (sr.add.op.name, sr.mult.name) != ("PLUS", "TIMES"):
        return False
    if any(t.is_udt for t in (sr.ztype, sr.xtype, sr.ytype, A.type)):
        return False      # a struct type has no dtype to test
    if np.dtype(sr.ztype.dtype) != np.float32:
        return False
    opt = A._options.get("bsr_spmv")
    if opt is False:
        return False
    if opt is not True and A.device.type == "cpu":
        return False
    if A.nvals == 0:
        return False
    gate_key = ("_bsr_spmv_ok", T)
    cached = A._options.get(gate_key)
    if cached is not None:
        return cached
    plan = A._options.get(("_bsr_spmv_plan", T, np.dtype(np.float32).str))
    if plan is not None:
        ntiles = plan.ntiles
    else:
        rows, cols = _host_rows_cols(A)
        live = rows < A.nrows
        ncb = -(-A.ncols // T)
        tid = (rows[live] // T).astype(np.int64) * ncb + cols[live] // T
        ntiles = len(np.unique(tid))
    ok = (ntiles * T * T * 4 <= MAX_TILE_BYTES
          and A.nvals / max(ntiles, 1) >= MIN_NNZ_PER_TILE)
    A._options[gate_key] = ok
    return ok


def _bsr_spmv_plain(plan: BsrSpmvPlan, xpad: torch.Tensor,
                    chunk: int = 2048) -> torch.Tensor:
    """Plain version of the kernel: per chunk of triples, gather the
    tiles and x blocks, ``bmm``, and ``index_add`` into the row-blocks
    (valid == 0 triples add nothing).  Computes in the dtype of
    ``plan.tiles`` and ``xpad`` (both the same); returns (nrb * T,)."""
    tiles = plan.tiles
    T = tiles.shape[1]
    xb = xpad.reshape(-1, T, 1)
    y = torch.zeros(plan.nrb, T, dtype=tiles.dtype, device=tiles.device)
    for s in range(0, plan.rb.shape[0], chunk):
        e = s + chunk
        prod = torch.bmm(tiles[plan.slot[s:e].long()],
                         xb[plan.cb[s:e].long()])[..., 0]
        prod = prod * plan.valid[s:e, None].to(prod.dtype)
        y.index_add_(0, plan.rb[s:e].long(), prod)
    return y.reshape(-1)


def bsr_spmv_tiles(plan: BsrSpmvPlan, xpad: torch.Tensor) -> torch.Tensor:
    """y (nrb * T,) f32 with y[rb*T + r] = sum over the row-block's valid
    triples t of sum_c tiles[slot[t]][r][c] * xpad[cb[t]*T + c], for x
    padded to ncb * T.  CUDA tensors launch the BSR SpMV kernel
    (``csrc/spmv.cu``); CPU tensors run its plain version."""
    tiles = plan.tiles
    T = tiles.shape[1]
    if tiles.dtype != torch.float32 or xpad.dtype != torch.float32:
        raise TypeError(f"tiles and x must be float32, got {tiles.dtype} "
                        f"and {xpad.dtype}")
    if tiles.dim() != 3 or tiles.shape[2] != T or T != TILE:
        raise ValueError(f"tiles must be (ntiles, {TILE}, {TILE}), got "
                         f"{tuple(tiles.shape)}")
    if tuple(xpad.shape) != (plan.ncb * T,):
        raise ValueError(f"x must be padded to {plan.ncb * T}, got "
                         f"{tuple(xpad.shape)}")
    dev = tiles.device
    for name in ("rb", "cb", "slot", "valid", "rbptr"):
        a = getattr(plan, name)
        if a.dtype != torch.int32 or a.device != dev:
            raise TypeError(f"plan.{name} must be int32 on {dev}")
    if xpad.device != dev or not (tiles.is_contiguous()
                                  and xpad.is_contiguous()):
        raise ValueError("tiles and x must be contiguous, on one device")
    if dev.type == "cpu":
        return _bsr_spmv_plain(plan, xpad)
    y = torch.empty(plan.nrb * T, dtype=torch.float32, device=dev)
    _build.launch("bsr_spmv", tiles, plan.rbptr.data_ptr(),
                  plan.cb.data_ptr(), plan.slot.data_ptr(),
                  plan.valid.data_ptr(), tiles.data_ptr(), xpad.data_ptr(),
                  y.data_ptr(), plan.nrb)
    return y


def bsr_spmv(sr: Semiring, A: CsrMatrix, x: torch.Tensor):
    """(yvals, ypat) = A (PLUS_TIMES f32) x through the tile kernel.
    ``x`` is the dense [ncols] f32 value tensor (cast by the caller);
    the pattern comes from the row degrees, and y is 0 off it."""
    plan = bsr_spmv_plan(A)
    T = plan.tiles.shape[1]
    xpad = torch.zeros(plan.ncb * T, dtype=torch.float32, device=A.device)
    xpad[: A.ncols] = x.to(torch.float32)
    y = bsr_spmv_tiles(plan, xpad)[: A.nrows]
    ip = A.indptr.long()
    ypat = ip[1:] > ip[:-1]
    y = torch.where(ypat, y.to(sr.ztype.storage),
                    torch.zeros((), dtype=sr.ztype.storage, device=y.device))
    record_axb_method(("cuda:" if y.is_cuda else "torch:") + "bsr_spmv")
    return y, ypat
