"""BSR tile-triple masked product: the hand-written CUDA kernel K7 and
the large-graph ``masked_mxm`` built on it.

Counterpart of ``graphblas_tpu/sparse/pallas_bsr.py``: the Pallas TPU
kernel becomes a CUDA C++ kernel for Hopper (``csrc/bsr.cu``), built with
``nvcc`` on first use and called through ctypes on PyTorch's current
stream.  The names are the JAX package's.

For every nonempty tile (I, J) of the mask's grid the kernel computes
``C[o] = (sum_K A(I, K) · B(J, K)ᵀ) * (M(I, J) != 0)``: int8 0/1 tiles into
int32 (the counting semirings) or float32 value tiles into float32
(PLUS_TIMES, true float32).  The schedule lists each output's (A tile,
B tile) pairs in (I, J, K) order; it is built on the host by joining the
grids' nonempty tiles (:func:`bsr.tile_triples`), not from the JAX
package's dense Tm x Tn x Tk cube, which cannot be built at Wathen 384
(3,469³ booleans).  On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs the plain PyTorch version defined here.

Engine names (``last_axb_method``), port <-> JAX package:

    cuda:bsr_count  / torch:bsr_count   <->  pallas:bsr_count
    cuda:bsr_values / torch:bsr_values  <->  pallas:bsr_values

``masked_mxm`` keeps the JAX function's behaviour, with one repair: value
tiles hold 0 at absent positions, so a present ±inf or NaN against an
absent entry forms ``inf · 0 = NaN``, a pair GraphBLAS never forms (the
JAX ``masked_mxm`` returns NaN there; ROADMAP.md queue 3).  The values
mode therefore takes K7 only for finite operands and otherwise runs the
ESC engine, which multiplies present pairs only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..core.errors import DimensionMismatch
from ..ops.flopcount import record_axb_method
from .bsr import (TILE, TilePattern, tile_matrix, tile_pattern, tile_products,
                  tile_triples)

__all__ = ["build_schedule", "bsr_masked_mm_pallas",
           "bsr_masked_count_pallas", "tricount_bsr_pallas", "masked_mxm"]

#: tile triples per batched product of the plain version
_PLAIN_CHUNK = 1 << 12


def _schedule(Mp: TilePattern, Ap: TilePattern, Bp: TilePattern):
    """Host schedule as numpy: (starts, ta, tb, mslot, kmax, outs), or
    None when there is no triple or no output tile.  ``mslot[o]`` is
    output o's tile in M's stack."""
    gm = Mp.grid
    I, J, K = tile_triples(gm, Ap.grid, Bp.grid)
    outs = np.nonzero(gm)
    nout = len(outs[0])
    if len(I) == 0 or nout == 0:
        return None
    out_index = np.zeros(gm.shape, np.int32)
    out_index[outs] = np.arange(nout, dtype=np.int32)
    # triples come in (I, J, K) order, so their output ids ascend
    counts = np.bincount(out_index[I, J], minlength=nout)
    starts = np.zeros(nout + 1, np.int32)
    starts[1:] = np.cumsum(counts)
    return (starts, Ap.index[I, K].astype(np.int32),
            Bp.index[J, K].astype(np.int32),
            Mp.index[outs].astype(np.int32), int(counts.max()),
            np.stack(outs, 1))


def build_schedule(Mp: TilePattern, Ap: TilePattern, Bp: TilePattern):
    """Tile-triple schedule of C<M> = A · B': returns (starts, ta, tb,
    Mtiles, kmax, outs), the JAX function's arrays in its order, or None
    when there is no work.  ``starts`` (nout+1,), ``ta``/``tb`` (ntriples,)
    int32 tensors index A's and B's stacked tiles, ``Mtiles`` are M's
    output tiles gathered in output order, all on A's tiles' device;
    ``outs`` (nout, 2) numpy tile coordinates in row-major order."""
    sched = _schedule(Mp, Ap, Bp)
    if sched is None:
        return None
    starts, ta, tb, mslot, kmax, outs = sched
    dev = Ap.tiles.device
    Mtiles = Mp.tiles[torch.from_numpy(mslot.astype(np.int64)).to(
        Mp.tiles.device)].to(dev)
    return (torch.from_numpy(starts).to(dev), torch.from_numpy(ta).to(dev),
            torch.from_numpy(tb).to(dev), Mtiles, kmax, outs)


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _bsr_mm_plain(starts, ta, tb, mslot, Atiles, Btiles, Mtiles,
                  acc_dtype) -> torch.Tensor:
    """Plain version of K7: every triple's tile product ``A[ta[s]] @
    B[tb[s]]ᵀ`` summed into its output (``index_add_``), then times
    ``(M[mslot[o]] != 0)``.  Integer tiles multiply in float64 (exact at
    these sums), float tiles in their own dtype with TF32 off; the
    result is cast to ``acc_dtype``."""
    nout = starts.shape[0] - 1
    work = Atiles.dtype if Atiles.is_floating_point() else torch.float64
    counts = (starts[1:] - starts[:-1]).long()
    oid = torch.repeat_interleave(
        torch.arange(nout, device=Atiles.device), counts)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = tile_products(Atiles, Btiles, ta.long(), tb.long(), oid, nout,
                            work, work, _PLAIN_CHUNK)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    mask = (Mtiles[mslot.long()] != 0).to(work)
    return (out * mask).to(acc_dtype)


def _check_tiles(starts, ta, tb, mslot, Atiles, Btiles, Mtiles,
                 acc_dtype) -> torch.device:
    """Raise on what K7 does not take; returns the common device."""
    dev = Atiles.device
    want = torch.int8 if acc_dtype == torch.int32 else torch.float32
    if acc_dtype not in (torch.int32, torch.float32):
        raise TypeError(f"acc_dtype must be int32 (counting) or float32 "
                        f"(values), got {acc_dtype}")
    for name, x, dt, dim in (
            ("starts", starts, torch.int32, 1), ("ta", ta, torch.int32, 1),
            ("tb", tb, torch.int32, 1), ("mslot", mslot, torch.int32, 1),
            ("A tiles", Atiles, want, 3), ("B tiles", Btiles, want, 3),
            ("M tiles", Mtiles, torch.int8, 3)):
        if x.dtype != dt or x.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D {dt} tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    T = Atiles.shape[1]
    for name, x in (("A", Atiles), ("B", Btiles), ("M", Mtiles)):
        if tuple(x.shape[1:]) != (T, T):
            raise ValueError(f"{name} tiles {tuple(x.shape)} are not "
                             f"square {T}x{T} tiles")
    if dev.type == "cuda" and T != TILE:
        raise ValueError(f"the kernel takes {TILE}x{TILE} tiles, got {T}")
    if dev.type == "cuda" and any(x.data_ptr() % 16
                                  for x in (Atiles, Btiles, Mtiles)):
        raise ValueError("the kernel takes tile stacks that start 16-byte "
                         "aligned")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def bsr_tiles_mm(starts, ta, tb, mslot, Atiles, Btiles, Mtiles,
                 acc_dtype=torch.int32) -> torch.Tensor:
    """K7 on a schedule: (nout, T, T) of ``acc_dtype`` (int32 from int8
    tiles, float32 from float32 tiles), output o the sum over its
    triples of ``A[ta[s]] @ B[tb[s]]ᵀ`` times ``(M[mslot[o]] != 0)``.
    CUDA tensors launch the kernel; CPU tensors run its plain version."""
    acc_dtype = _torch_dtype(acc_dtype)
    dev = _check_tiles(starts, ta, tb, mslot, Atiles, Btiles, Mtiles,
                       acc_dtype)
    if dev.type == "cpu":
        return _bsr_mm_plain(starts, ta, tb, mslot, Atiles, Btiles, Mtiles,
                             acc_dtype)
    nout = starts.shape[0] - 1
    out = torch.empty((nout, TILE, TILE), dtype=acc_dtype, device=dev)
    _build.launch("bsr_masked_mm", Atiles, starts.data_ptr(), ta.data_ptr(),
                  tb.data_ptr(), mslot.data_ptr(), Atiles.data_ptr(),
                  Btiles.data_ptr(), Mtiles.data_ptr(), out.data_ptr(), nout,
                  int(acc_dtype == torch.float32))
    return out


def _ones_mask(Ap: TilePattern, Bp: TilePattern) -> TilePattern:
    """The unmasked product's mask: the boolean product of A's and B's
    tile grids (a sound bound on C's structure), every output tile
    reading one shared all-ones tile (slot 0)."""
    T = Ap.T
    grid = (Ap.grid.astype(np.float32) @ Bp.grid.T.astype(np.float32)) > 0
    ones = torch.ones((1, T, T), dtype=torch.int8, device=Ap.tiles.device)
    return TilePattern(ones, grid, np.zeros(grid.shape, np.int32),
                       (grid.shape[0] * T, grid.shape[1] * T), T)


def bsr_masked_mm_pallas(Mp: Optional[TilePattern], Ap: TilePattern,
                         Bp: TilePattern, acc_dtype=torch.int32
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """C<M> = A · B' over M's nonempty tiles through K7: returns (C
    tiles (nout, T, T) of ``acc_dtype`` on A's tiles' device, their tile
    coordinates (nout, 2)).  Int8 0/1 tiles with int32 count (PLUS_LAND);
    float32 value tiles with float32 compute PLUS_TIMES.  ``Mp=None``
    computes the unmasked product over the boolean product of the tile
    grids.  The name is the JAX package's."""
    acc_dtype = _torch_dtype(acc_dtype)
    if Mp is None:
        Mp = _ones_mask(Ap, Bp)
    return _run_schedule(_schedule(Mp, Ap, Bp), Mp, Ap, Bp, acc_dtype)


def _run_schedule(sched, Mp: TilePattern, Ap: TilePattern, Bp: TilePattern,
                  acc_dtype: torch.dtype) -> Tuple[torch.Tensor, np.ndarray]:
    """K7 over a host schedule of :func:`_schedule` whose tile ids index
    ``Ap``'s, ``Bp``'s and ``Mp``'s stacks; None gives M's output tiles
    as zeros.  Returns (C tiles, their tile coordinates)."""
    dev = Ap.tiles.device
    if sched is None:
        outs = np.nonzero(Mp.grid)
        return (torch.zeros((len(outs[0]), Ap.T, Ap.T), dtype=acc_dtype,
                            device=dev), np.stack(outs, 1))
    starts, ta, tb, mslot, _, outs = sched

    def t(a):
        return torch.from_numpy(a).to(dev)

    C = bsr_tiles_mm(t(starts), t(ta), t(tb), t(mslot), Ap.tiles, Bp.tiles,
                     Mp.tiles.to(dev), acc_dtype)
    return C, outs


def bsr_masked_count_pallas(Mp: TilePattern, Ap: TilePattern,
                            Bp: TilePattern
                            ) -> Tuple[torch.Tensor, np.ndarray]:
    """Counting form of :func:`bsr_masked_mm_pallas` (PLUS_LAND)."""
    return bsr_masked_mm_pallas(Mp, Ap, Bp, torch.int32)


def tricount_bsr_pallas(Lp, Up, T: int = TILE, device=None) -> int:
    """SandiaDot triangle count through K7: the sum of (L · U') .* L over
    L's tiles.  ``Lp``/``Up``: the strictly lower/upper patterns (numpy
    or tensors; numpy goes to ``device``, the card by default)."""
    Lt = tile_pattern(Lp, T, device)
    Ut = tile_pattern(Up, T, device)
    C, _ = bsr_masked_count_pallas(Lt, Lt, Ut)
    return int(C.sum(dtype=torch.int64))


def _bitmap(X, what: str):
    """(values, pattern, type) of a bitmap Matrix, CsrMatrix or
    CscMatrix operand; the values are None for a user-defined type (the
    structural modes read the pattern only, as the JAX package's)."""
    from ..core.matrix import Matrix
    from ..ops.containers import UnsupportedContainer
    from .container import CscMatrix, CsrMatrix
    if isinstance(X, (CsrMatrix, CscMatrix)):
        X = X.to_matrix()
    if not isinstance(X, Matrix):
        raise UnsupportedContainer(f"masked_mxm {what}: expected a Matrix "
                                   f"or CsrMatrix, got {type(X).__name__}")
    X = X.wait()
    return (None if X.type.is_udt else X.values), X.pattern, X.type


def _mode(semiring) -> str:
    """Which algebra the tile engine runs for ``semiring`` (None:
    structural pair counts)."""
    if semiring is None:
        return "count_structural"
    pair = (semiring.add.op.name, semiring.mult.name)
    if semiring.ztype.is_bool:
        # boolean renames (GB_boolean_rename): PLUS≡MAX≡LOR,
        # TIMES≡MIN≡LAND on bool
        ren = {"PLUS": "LOR", "MAX": "LOR", "TIMES": "LAND", "MIN": "LAND"}
        pair = (ren.get(pair[0], pair[0]), ren.get(pair[1], pair[1]))
    if pair == ("PLUS", "TIMES"):
        return "values"
    if pair == ("PLUS", "PAIR"):
        return "count_structural"
    if pair == ("PLUS", "LAND"):
        return "count_truthy"
    if pair in (("LOR", "LAND"), ("LOR", "PAIR")):
        return "bool"
    raise NotImplementedError(
        f"semiring {pair} is not expressible on the BSR tile engine; use "
        f"gt.mxm (bitmap backend) instead")


def _esc_values(Av, Apat, At, Bv, Bpat, Bt, Mpat):
    """FP32 PLUS_TIMES on M ∩ structure(A·B) through the ESC engine,
    which multiplies present pairs only; values cast to float32 as the
    value tiles are.  Returns (values, structural pattern) (m, n)."""
    from ..core.matrix import Matrix
    from ..core.semirings import semiring as catalog
    from ..core.types import FP32, cast
    from .container import CsrMatrix
    from .esc import csr_spgemm

    def csr(v, p, t):
        return CsrMatrix.from_matrix(Matrix(cast(v, FP32, t), p, FP32))

    Mc = None if Mpat is None else csr(
        torch.ones_like(Mpat, dtype=torch.float32), Mpat, FP32)
    Tc = csr_spgemm(catalog.plus_times[FP32], csr(Av, Apat, At),
                    csr(Bv, Bpat, Bt), mask=Mc, structural=True)
    Tm = Tc.to_matrix()
    return Tm.values, Tm.pattern


def masked_mxm(M, A, B, semiring=None, T: int = TILE):
    """Large-graph mxm: C<M> = A (+.x) B through the BSR tile engine.

    M/A/B: bitmap Matrix or CsrMatrix; ``M=None`` computes the unmasked
    product (output structure bounded by the tile-grid product).
    PLUS_TIMES uses float32 value tiles; boolean/counting semirings use
    int8 pattern tiles.  Returns a bitmap Matrix on the exact structure
    of the product intersected with the mask, on A's device, assembled
    there from the output tiles."""
    from ..core.matrix import Matrix
    from ..core.types import BOOL, FP32, INT32, cast

    Av, Apat, At = _bitmap(A, "A")
    Bv, Bpat, Bt = _bitmap(B, "B")
    # dispatch: None / PLUS_PAIR -> structural counts (INT32), PLUS_LAND
    # -> truthy counts (INT32), LOR_LAND -> truthy reachability (BOOL),
    # PLUS_TIMES -> float product (FP32); anything else raises
    mode = _mode(semiring)
    if mode != "count_structural" and (Av is None or Bv is None or any(
            t.is_complex for t in (At, Bt))):
        # the value and truthy tiles hold real builtin values
        raise TypeError(f"the tile engine's {mode} mode takes builtin "
                        f"real values, not {At.name} x {Bt.name}; use "
                        f"gt.mxm")
    if Apat.shape[1] != Bpat.shape[0]:
        raise DimensionMismatch(f"inner dims {tuple(Apat.shape)} x "
                                f"{tuple(Bpat.shape)}")
    if mode == "values" and (
            any(t.name == "FP64" for t in (At, Bt))
            or semiring.ztype.name == "FP64"):
        # value tiles compute at float32; an FP64 PLUS_TIMES must go
        # through gt.mxm (float64 accumulation), not degrade precision
        raise TypeError("BSR value tiles compute at f32 precision; FP64 "
                        "PLUS_TIMES must go through gt.mxm (f64 "
                        "accumulation)")
    # the output pattern is the structural product (GraphBLAS), even when
    # the values reduce over truthy pairs only
    Apt_s = tile_pattern(Apat, T)
    Bpt_s = tile_pattern(Bpat.T, T)
    Apt, Bpt = Apt_s, Bpt_s
    if mode in ("count_truthy", "bool"):
        Apt = tile_pattern(Apat & (Av != 0), T)
        Bpt = tile_pattern((Bpat & (Bv != 0)).T, T)
    m, n = Apat.shape[0], Bpat.shape[1]
    dev = Apat.device
    if M is None:
        Mpat = None
        Mt = _ones_mask(Apt_s, Bpt_s)
    else:
        _, Mpat, _ = _bitmap(M, "M")
        if tuple(Mpat.shape) != (m, n):
            raise DimensionMismatch(f"mask {tuple(Mpat.shape)} vs product "
                                    f"{(m, n)}")
        Mt = tile_pattern(Mpat, T)
    # structural pair counts: the output pattern (M ∩ structure(A·B'))
    sched_s = _schedule(Mt, Apt_s, Bpt_s)
    Cnt_s, outs = _run_schedule(sched_s, Mt, Apt_s, Bpt_s, torch.int32)
    route = "cuda" if dev.type == "cuda" else "torch"
    if mode == "values":
        finite = all(bool(torch.isfinite(v[p]).all())
                     for v, p, t in ((Av, Apat, At), (Bv, Bpat, Bt))
                     if t.is_float)
        if not finite:
            vals, spat = _esc_values(Av, Apat, At, Bv, Bpat, Bt, Mpat)
            pat = spat if Mpat is None else spat & Mpat
            return Matrix(torch.where(pat, vals, 0.0), pat, FP32)
        # value tiles are cut from the same patterns as Apt_s and Bpt_s,
        # so they have the same grids and tile ids: the structural
        # schedule serves the second launch
        Ap = tile_matrix(cast(Av, FP32, At), Apat, T)
        Bp = tile_matrix(cast(Bv, FP32, Bt).T, Bpat.T, T)
        C, _ = _run_schedule(sched_s, Mt, Ap, Bp, torch.float32)
        out_t = FP32
        record_axb_method(f"{route}:bsr_values")
    elif mode == "count_structural":
        C = Cnt_s
        out_t = INT32
        record_axb_method(f"{route}:bsr_count")
    else:  # count_truthy / bool: counts over truthy pairs
        C, outs = bsr_masked_mm_pallas(Mt, Apt, Bpt, torch.int32)
        out_t = INT32
        record_axb_method(f"{route}:bsr_count")
    # reassemble on the device: scatter the output tiles into the grid
    Tm, Tn = Mt.grid.shape
    I = torch.from_numpy(outs[:, 0].astype(np.int64)).to(dev)
    J = torch.from_numpy(outs[:, 1].astype(np.int64)).to(dev)

    def place(tiles):
        full = torch.zeros((Tm, Tn, T, T), dtype=tiles.dtype, device=dev)
        full[I, J] = tiles
        return full.permute(0, 2, 1, 3).reshape(Tm * T, Tn * T)[:m, :n]

    Cn = place(C)
    pat = place(Cnt_s) > 0
    if Mpat is not None:
        pat = pat & Mpat
    if mode == "bool":
        return Matrix(pat & (Cn > 0), pat, BOOL)
    return Matrix(torch.where(pat, Cn, torch.zeros((), dtype=Cn.dtype,
                                                   device=dev)), pat, out_t)
