#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card (triangle
counting, the masked valued product ``mxm``, SpMV with BFS and
PageRank, ``mxm`` into a bitmap ``Matrix``: all-pairs shortest paths
by min-plus squaring and an SpMM, and the BSR tile engine with k-truss
and the gather probes), and check each hand-written kernel against its
plain PyTorch version.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure is an
uncaught exception and a nonzero exit):

1. build the CUDA kernels with nvcc (printing ptxas's register report);
2. each kernel against its plain version on the card, exact integer
   equality: band-ring and window-count on the Wathen nx=ny=128 plans,
   the popcount pass on random panels (W = 8, 40, 1024, with and without
   row maps, entries past nvals);
3. Wathen nx=ny=16 against a dense numpy oracle, then Wathen nx=ny=128
   through ``tricount_auto`` (884,992 triangles, band-ring engine) and
   ``window_count_partials`` on its window plan (884,992 again);
4. Wathen nx=ny=384: ``tricount_auto`` (band ring) equals
   ``tricount_esc`` on the same L/U;
5. R-MAT scale 16 (edge factor 16, seed 7): nnz 1,819,622 and
   ``tricount_esc`` 15,623,664;
6. R-MAT scale 18: nnz 7,612,718 and 82,947,332 triangles;
7. the popcount pass against its plain version at the scale-18 plan's
   shapes;
8. the gather-dot kernel (valdot, K4) against its plain version on
   random panels (S = 1024 and 4096, float32 and int32, padded lane
   lists with nlive < E and a -1 index): int32 exactly, float32 against
   a float64 plain result within the reassociation bound
   S * 2^-24 * sum_s |a_s * b_s| per lane;
9. the masked valued product on R-MAT 16 and 18 with bench.py's value
   recipe (values for L, then U, then the mask M on L's pattern, from
   ``default_rng(3)``): ``mxm(C0, M, None, "plus_times", L, U)`` with an
   empty FP32 CSR ``C0`` gives nnzC 391,597 and 1,533,157, through
   ``valdot:*`` at scale 18, and equals the ESC-only engine
   (``Descriptor(axb_method="gustavson")``): the pattern exactly, values
   within rtol=5e-5, atol=1e-4;
10. the gather-dot kernel at the main path's shapes (the first level of
   the R-MAT 18 plan) against its plain version and one library call
   for the same function (``torch.sparse.sampled_addmm`` over the live
   pairs, timed only here), its ns per live lane, and the ESC residual's
   ns per lane;
11. the BSR SpMV kernel (K5) against its plain version at the Wathen
   nx=ny=256 plan (15,425 tiles): per row within K * 2^-24 *
   sum_c |a_rc * x_c| of the float64 product (K: the row's term count),
   timed in turns with its plain version and the library call for the
   same function (``torch.sparse_bsr_tensor(crow, col, tiles) @ x``,
   cuSPARSE bsrmv, timed only here);
12. SpMV on Wathen 256 (FP32, duplicates summed): ``mxv(w, None, None,
   "plus_times", A, u)`` with a dense u through ``cuda:bsr_spmv``,
   first and warm, against a float64 scipy CSR product and against the
   dense-x engine (``A._options["bsr_spmv"] = False``, also timed);
   ``vxm`` with TRAN1;
13. SpMV on the R-MAT 18 graph of phase 6 (symmetrized): a dense
   ``plus_times[FP32]`` ``mxv`` (dense-x engine) against scipy, one
   frontier step ``vxm(lor_land)`` from vertex 0 with the complemented
   mask and REPLACE (sparse-x engine), ``bfs_csr`` from vertex 0 (level
   counts exact) and ``pagerank_csr(iters=20)`` (top-10 vertices exact),
   anchors taken from the JAX package on the CPU;
14. the tropical kernel (K6) against its plain version, all six pairs at
   (1000 x 1100) . (1100 x 900) with about 1 % +-inf and NaN values:
   equal bit for bit up to the sign of zero, NaN where NaN; then
   min-plus at 4096^3 timed in turns (kernel, plain once, kernel);
15. the window product kernel (K3) against its plain version on the
   Wathen 128 window plan, exact, timed in turns with ``torch.bmm`` of
   the panels in float16 (the unmasked product, exact at these counts;
   timed only here);
16. the bitmap ``mxm`` path: all-pairs shortest paths on R-MAT 12 (edge
   factor 16, seed 7, symmetrized; weights U[1, 10) float32 from
   ``default_rng(5)`` on the upper triangle, mirrored; a 0 diagonal) by
   ``D = mxm(D, None, binary.min[FP32], "min_plus", D, D)`` until D stops
   changing, each product through ``cuda:tropical_min_plus``, against
   scipy's float64 Dijkstra (reachability exact, distances within
   rtol=1e-5); one SpMM, ``mxm`` of the R-MAT 18 graph by a dense
   float32 X (n, 32) into a bitmap C through ``spmm:ell``, per row within
   K * 2^-24 * sum |a * x| of scipy float64; ``window_masked_mm_pallas``
   on the Wathen 128 window plan, whose panels sum to 884,992;
17. the BSR tile-triple kernel (K7) against its plain version: counting
   at the Wathen 128 schedule (M = A = L, B = Uᵀ from COO tiles; 5,151
   triples) exactly; values at Wathen 64 with bench.py's values (L, then
   U, from ``default_rng(3)``) within K * 2^-24 * sum |a * b| per entry
   of the float64 plain result (K = 128 * the output's triple count),
   and once more with one +inf value (NaN where NaN, the same infinities,
   the rest within the bound); then timed at Wathen 384 (52,820 triples)
   in turns with its plain version and the gathered-tile float16
   ``torch.bmm`` + ``index_add_`` on the same triples (the library
   formulation, unmasked; timed only here), and the values form timed on
   the same schedule with 0/1 float32 tiles (equal to the counts);
18. the probes' kernels: the row-window gather (P1) against
   ``torch.take_along_dim`` at the TPU probe's shape (2^15 rows x 128),
   exactly, timed beside it, with ``torch.take``'s flat gather rate; the
   ``cp.async`` gather-dot (P2) against ``(A[ai] * B[bj]).sum(1)`` and
   the gather-dot kernel K4 at the TPU probe's tables (32,768 x 1,024
   float32, 65,536 pairs), each within S * 2^-24 * sum a * b of the
   float64 sum, timed in turns with ``torch.sparse.sampled_addmm`` over
   the distinct pairs (the library call, timed only here);
19. the tile engine, k-truss and the probes through their entry points:
   ``bsr_masked_count_pallas`` on Wathen 128 from COO tiles (884,992)
   and Wathen 384 (equal to phase 4's count); ``tricount_bsr_pallas`` on
   the Wathen 16 patterns (the phase-3 oracle); ``masked_mxm(L, L, U)``
   on Wathen 64 with bench.py's values in its four modes against
   ``mxm`` into a bitmap with the same mask (counts and patterns exact,
   the structural counts summing to ``tricount_auto``'s; values within
   rtol=1e-5, atol=1e-4); ``ktruss_esc`` on the symmetrized R-MAT 16
   (k=5: 726,973 edges, 10 sweeps) and 18 (k=10: 2,292,950 edges, 13
   sweeps), edges being half the symmetric truss's entries, through
   ``bitdot:ktruss_incremental``; ``allktruss_esc`` on R-MAT 16 to k=5;
   and both probes' ``run()``.

Launch counters are zeroed just before each path and read just after
it: before phase 3 and after phase 9 (triangle counting and ``mxm``:
the first four kernels), before phase 12 and after phase 13 (SpMV: K5),
before and after phase 16 (the bitmap ``mxm`` path: K6 and K3), before
and after phase 19 (the tile engine, k-truss and the probes: K7, the
popcount pass and both probe kernels); every kernel of a path must have
launched there.  The line before the
last is the per-kernel JSON summary, with each kernel's bound (the
larger of its compulsory bytes over 3.35 TB/s and its operations over
the card's peak for their type); the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

WATHEN_128_NTRI = 884_992
RMAT_ANCHORS = {16: (1_819_622, 15_623_664), 18: (7_612_718, 82_947_332)}
VALUED_NNZC = {16: 391_597, 18: 1_533_157}
# Wathen nx=ny=256, duplicates summed: n, nnz, occupied 128x128 tiles
WATHEN_256 = (197_633, 3_084_289, 15_425)
# R-MAT 18 (ef 16, seed 7, symmetrized), from the JAX package on the CPU:
# bfs_csr(A, 0) level -> vertex count (0 = unreached) and the
# pagerank_csr(A, 20) top-10 vertices in rank order
RMAT18_BFS_LEVELS = {0: 88_501, 1: 1, 2: 25_261, 3: 140_309, 4: 8_041,
                     5: 31}
RMAT18_PAGERANK_TOP10 = [0, 32, 16384, 1024, 512, 2048, 2, 16, 8192, 4]
# the kernels each path must launch
MXM_PATH = ("tri_band_ring", "window_count", "bitdot_popcount",
            "valdot_gatherdot")
SPMV_PATH = ("bsr_spmv",)
BITMAP_PATH = ("tropical_mm", "window_mm")
BSR_PATH = ("bsr_masked_mm", "bitdot_popcount", "row_gather",
            "gatherdot_async")
# k-truss of the symmetrized R-MAT graphs (ef 16, seed 7): scale -> (k,
# undirected edges = half the truss's entries, sweeps), ROADMAP.md anchors
KTRUSS_ANCHORS = {16: (5, 726_973, 10), 18: (10, 2_292_950, 13)}

# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# int8 tensor-core ops/s, and the CUDA cores' 32-bit ops/s (the float32
# rate outside the tensor cores, used for 32-bit integer ops too)
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
CUDA32_OPS = 67e12


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def timed(fn):
    """(result, seconds) of fn() up to a device synchronize."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls (warmed)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {got.dtype} {tuple(got.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def turns(kernel, plain, reps: int, plain_reps: int = None, library=None):
    """Device times in turns: plain, kernel[, library, library], kernel,
    plain.  Returns (kernel_ms, plain_ms[, library_ms]), each the better
    of its two turns."""
    plain_reps = plain_reps or reps
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, reps)
    if library is not None:
        l1 = cuda_ms(library, reps)
        l2 = cuda_ms(library, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, plain_reps)
    if library is None:
        return min(k1, k2), min(p1, p2)
    return min(k1, k2), min(p1, p2), min(l1, l2)


def compare_timed(kernel, plain, reps: int):
    """Exact comparison, then device times in turns.  Returns
    (max_abs_err, kernel_ms, plain_ms)."""
    err = max_abs_err(kernel(), plain())
    if err:
        raise AssertionError(f"kernel differs from plain version by {err}")
    return (err, *turns(kernel, plain, reps))


def bound(nbytes: float, ops: float, ops_rate: float):
    """(bound_ms, bound_by): the least time the card could take."""
    tb, to = nbytes / HBM_BPS, ops / ops_rate
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def distinct(x: torch.Tensor) -> int:
    return int(torch.unique(x).numel())


def check_gatherdot(got: torch.Tensor, Av, Bv, ai, bj, nlive: int):
    """Max |error| of a gather-dot result: int32 exactly against the
    plain version; float32 against the float64 sum, each lane within the
    reassociation bound S * 2^-24 * sum_s |a_s * b_s|.  Lanes past
    nlive must be 0."""
    from graphblas_tpu_torch.sparse import valdot as vd
    if int(got[nlive:].abs().sum()):
        raise AssertionError("gather-dot lanes past nlive not 0")
    if got.dtype == torch.int32:
        return max_abs_err(got, vd._gatherdot_plain(Av, Bv, ai, bj, nlive))
    S = Av.shape[1]
    worst = 0.0
    step = max(1, (1 << 24) // S)
    for s in range(0, nlive, step):
        e = min(s + step, nlive)
        a = Av[ai[s:e].long().clamp(0, Av.shape[0] - 1)].double()
        b = Bv[bj[s:e].long().clamp(0, Bv.shape[0] - 1)].double()
        w = a * b
        err = (got[s:e].double() - w.sum(1)).abs()
        tol = S * 2.0 ** -24 * w.abs().sum(1)
        if bool((err > tol).any()):
            raise AssertionError(f"gather-dot beyond the bound: max err "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def spmv_error(got: torch.Tensor, plan, xpad: torch.Tensor,
               deg: torch.Tensor) -> float:
    """Max |error| of a BSR SpMV result (nrb * 128,) against the float64
    plain version; each row within K * 2^-24 * sum_c |a_rc * x_c|, K the
    row's term count ``deg`` (at least 1; padded rows must be 0)."""
    from graphblas_tpu_torch.sparse import cuda_spmv as cs
    want = cs._bsr_spmv_plain(plan._replace(tiles=plan.tiles.double()),
                              xpad.double())
    mag = cs._bsr_spmv_plain(plan._replace(tiles=plan.tiles.abs().double()),
                             xpad.abs().double())
    K = torch.ones_like(want)
    K[:deg.numel()] = deg.double().clamp(min=1)
    err = (got.double() - want).abs()
    if got.shape != want.shape or bool((err > K * 2.0 ** -24 * mag).any()):
        raise AssertionError(f"BSR SpMV beyond the bound: max err "
                             f"{float(err.max())}")
    return float(err.max())


def scipy_check(y: np.ndarray, pat: np.ndarray, A, x: torch.Tensor):
    """(max |error|, per-row bound) of an SpMV result y = A x, or an SpMM
    result y = A X (x of shape (n, k)), against the float64 scipy CSR
    product of A's stored values: each entry within K * 2^-24 *
    sum |a * x| (K the row's term count), and the pattern the rows with
    entries, in every column."""
    import scipy.sparse as ssp
    hp = A._options["host_pattern"]
    S = ssp.csr_matrix((A.values[:A.nvals].double().cpu().numpy(),
                        (hp[0][:A.nvals], hp[1][:A.nvals])), shape=A.shape)
    x64 = x.double().cpu().numpy()
    deg = np.diff(S.indptr).reshape((-1,) + (1,) * (x64.ndim - 1))
    ref = S @ x64
    tol = np.maximum(deg, 1) * 2.0 ** -24 * (abs(S) @ np.abs(x64))
    err = np.abs(y.astype(np.float64) - ref)
    assert np.array_equal(pat, np.broadcast_to(deg > 0, pat.shape)), \
        "pattern != rows with entries"
    if not (err <= tol).all():
        raise AssertionError(f"beyond the per-row bound: max err "
                             f"{err.max()}")
    return float(err.max()), tol


def wathen_lu(gt, nx: int):
    """Wathen nx x nx pattern as strictly lower/upper BOOL CSR on the
    card, assembled as bench.py does."""
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    iu, ju = iu[off], ju[off]
    lo, up = iu > ju, iu < ju
    L = gt.CsrMatrix.from_coo(iu[lo], ju[lo], np.ones(lo.sum(), bool), n, n,
                              type=gt.BOOL, sum_duplicates=False,
                              device="cuda")
    U = gt.CsrMatrix.from_coo(iu[up], ju[up], np.ones(up.sum(), bool), n, n,
                              type=gt.BOOL, sum_duplicates=False,
                              device="cuda")
    return L, U, n, len(iu)


def rmat_lu(gt, scale: int):
    """(L, U, nnz, A): the prepped triangular factors and the
    symmetrized graph itself."""
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    I, J = gt.symmetrize_pattern(I, J, n)
    A = gt.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gt.BOOL, sum_duplicates=False,
                              device="cuda")
    L, U = gt.tricount_prep_csr(A)
    return L, U, len(I), A


def with_values(gt, X, rng):
    """bench.py's value recipe on X's pattern: uniform [0.5, 1.5)
    float32 drawn from ``rng``, as an FP32 CSR on the card."""
    hp = X._options["host_pattern"]
    I, J = hp[0][:X.nvals], hp[1][:X.nvals]
    return gt.CsrMatrix.from_coo(
        I, J, rng.random(len(I)).astype(np.float32) + 0.5, X.nrows,
        X.ncols, type=gt.FP32, sum_duplicates=False, device="cuda")


def random_gatherdot_case(rng, S: int, dtype):
    """Random panels and a padded lane list for the gather-dot kernel:
    E lanes, nlive < E of them live, some ai = -1 (clipped to row 0)."""
    na, nb, E = 3000, 2500, 200_000
    nlive = E - E // 20 + 1
    if dtype == torch.float32:
        Av = torch.from_numpy(rng.random((na, S), np.float32) - 0.5)
        Bv = torch.from_numpy(rng.random((nb, S), np.float32) - 0.5)
    else:
        Av = torch.from_numpy(rng.integers(-2**31, 2**31, (na, S),
                                           dtype=np.int64).astype(np.int32))
        Bv = torch.from_numpy(rng.integers(-2**31, 2**31, (nb, S),
                                           dtype=np.int64).astype(np.int32))
    ai = torch.from_numpy(rng.integers(-1, na, E).astype(np.int32))
    bj = torch.from_numpy(rng.integers(0, nb, E).astype(np.int32))
    return tuple(x.to("cuda") for x in (Av, Bv, ai, bj)) + (nlive,)


def random_popcount_case(rng, W: int, maps: bool):
    """Random panels and mask entries for the popcount pass on the card:
    nzmax entries, the last 5% past nvals, maps with -1 rows."""
    na, nb, m, n, nzmax = 3000, 4000, 5000, 6000, 200_000
    nvals = nzmax - nzmax // 20
    dev = "cuda"
    Ap = torch.from_numpy(rng.integers(-2**31, 2**31, (na, W),
                                       dtype=np.int64).astype(np.int32))
    Bp = torch.from_numpy(rng.integers(-2**31, 2**31, (nb, W),
                                       dtype=np.int64).astype(np.int32))
    amap = bmap = None
    if maps:
        amap = torch.from_numpy(rng.integers(-1, na, m).astype(np.int32))
        bmap = torch.from_numpy(rng.integers(-1, nb, n).astype(np.int32))
    rows = rng.integers(0, m if maps else na, nzmax).astype(np.int32)
    cols = rng.integers(0, n if maps else nb, nzmax).astype(np.int32)
    return tuple(None if x is None else torch.as_tensor(x).to(dev)
                 for x in (Ap, Bp, amap, bmap, rows, cols)) + (nvals,)


def tropical_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when the tropical kernel's output equals the plain version's
    bit for bit up to the sign of zero (``==``) and NaN where NaN;
    raises otherwise."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"kernel gave {got.dtype} {tuple(got.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        raise AssertionError(f"tropical kernel differs from its plain "
                             f"version in {int((~same).sum())} entries")
    return 0.0


def with_specials(rng, shape) -> torch.Tensor:
    """float32 values in [-4, 4) with about 0.4 % +inf, 0.3 % -inf and
    0.3 % NaN, on the card."""
    x = rng.random(shape, np.float32) * 8 - 4
    u = rng.random(shape)
    x[u < 0.004] = np.inf
    x[(u >= 0.004) & (u < 0.007)] = -np.inf
    x[(u >= 0.007) & (u < 0.01)] = np.nan
    return torch.from_numpy(x).to("cuda")


def cuda_once(fn):
    """(result, device milliseconds) of one call."""
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def apsp_d0(gt, scale: int):
    """The all-pairs shortest-path start on R-MAT ``scale`` (edge factor
    16, seed 7, symmetrized): weights U[1, 10) float32 from
    ``default_rng(5)`` on the upper triangle, mirrored, and a 0 diagonal,
    as a bitmap FP32 Matrix on the card; also the scipy float64 graph
    without the diagonal."""
    import scipy.sparse as ssp
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    I, J = gt.symmetrize_pattern(I, J, n)
    up = I < J
    w = (1 + 9 * np.random.default_rng(5).random(int(up.sum()))
         ).astype(np.float32)
    d = np.arange(n)
    D0 = gt.Matrix.from_coo(np.concatenate([I[up], J[up], d]),
                            np.concatenate([J[up], I[up], d]),
                            np.concatenate([w, w, np.zeros(n, np.float32)]),
                            n, n, type=gt.FP32, device="cuda")
    G = ssp.csr_matrix((np.concatenate([w, w]).astype(np.float64),
                        (np.concatenate([I[up], J[up]]),
                         np.concatenate([J[up], I[up]]))), shape=(n, n))
    return D0, G


def wathen_tiles(gt, nx: int):
    """Wathen nx x nx (assembled as in ``wathen_lu``) as the tile
    patterns of L and of Uᵀ, built from COO on the card: M = A = L and
    B = Uᵀ give C = (L · U) .* L.  Also the off-diagonal (i, j) and n."""
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    iu, ju = iu[off], ju[off]
    lo, up = iu > ju, iu < ju
    Lt = gt.tile_pattern_from_coo(iu[lo], ju[lo], (n, n), device="cuda")
    Bt = gt.tile_pattern_from_coo(ju[up], iu[up], (n, n), device="cuda")
    return Lt, Bt, iu, ju, n


def k7_schedule(tcb, Mp, Ap, Bp):
    """(schedule tensors (starts, ta, tb, mslot) on the card, the numpy
    schedule) of C<M> = A · B'."""
    sched = tcb._schedule(Mp, Ap, Bp)
    return [torch.from_numpy(a).to("cuda") for a in sched[:4]], sched


def k7_bound(sched, in_bytes: int, out_bytes: int, ops_rate=INT8_OPS,
             a_is_m: bool = False):
    """K7's bound on a schedule: each distinct A, B and M tile read once
    (``in_bytes`` per A/B element, 1 per M element; a tile of one stack
    that serves as both A and M, ``a_is_m``, once), each output tile
    written once, the schedule read once; 2 * 128^3 operations per
    triple at ``ops_rate`` (int8 tensor-core peak for the counting form,
    the CUDA cores' float32 rate for the values form)."""
    starts, ta, tb, mslot, _, _ = sched
    t2 = 128 * 128
    if a_is_m:
        am = len(np.union1d(ta, mslot)) * t2 * in_bytes
    else:
        am = len(np.unique(ta)) * t2 * in_bytes + len(np.unique(mslot)) * t2
    nbytes = (am + len(np.unique(tb)) * t2 * in_bytes
              + len(mslot) * t2 * out_bytes
              + 4 * (len(starts) + len(ta) + len(tb) + len(mslot)))
    return bound(nbytes, 2 * 128 ** 3 * len(ta), ops_rate)


def values_err(got, want, mag, K):
    """Max |error| of a float32 K7 result against the float64 plain
    version: NaN where NaN, the same infinities, every finite entry
    within K * 2^-24 * mag (``mag``: the plain product of |tiles|)."""
    g = got.double()
    nan_w, inf_w = torch.isnan(want), torch.isinf(want)
    if not (torch.equal(torch.isnan(g), nan_w)
            and torch.equal(g[inf_w], want[inf_w])):
        raise AssertionError("K7 values differ in NaN or infinities")
    fin = ~(nan_w | inf_w)
    err = (g[fin] - want[fin]).abs()
    if bool((err > K * 2.0 ** -24 * mag[fin]).any()):
        raise AssertionError(f"K7 values beyond the bound: {err.max()}")
    return float(err.max()) if err.numel() else 0.0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    card = card_label()
    print(card, flush=True)
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import _build
    from graphblas_tpu_torch.sparse import bitdot as bd
    from graphblas_tpu_torch.sparse import cuda_spmv as cs
    from graphblas_tpu_torch.sparse import cuda_window as cw
    from graphblas_tpu_torch.sparse import esc as esc_mod
    from graphblas_tpu_torch.sparse import valdot as vd
    tag = f"[{card}]"
    summary = {}

    # ---- 1. build ----
    _, secs = timed(_build.library)
    info = _build.build_info or {}
    print(f"{tag} phase1 build: {secs:.3f} s (nvcc "
          f"{info.get('seconds', 0.0):.3f} s) -> {info.get('library')}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernels against their plain versions ----
    L, U, n, _ = wathen_lu(gt, 128)
    band = gt.build_band_plan(L, U)
    win = gt.build_window_plan(L, U, L)
    assert band is not None and win is not None, "Wathen 128 plans refused"
    print(f"{tag} phase2 band plan P {tuple(band.P.shape)} Wb {band.Wb}; "
          f"window plan P {tuple(win.P.shape)} Q {tuple(win.Q.shape)}")
    summary["tri_band_ring"] = compare_timed(
        lambda: gt.tricount_band_partials(band),
        lambda: cw._tri_band_partials_plain(band.P, band.Ut), 20)
    nI, _, W = band.P.shape
    Wb = W // 128
    macs = sum((nI - s) * 128 * 128 * (s + 1) * 128
               for s in range(min(Wb, nI)))
    bounds = {"tri_band_ring": bound(band.P.numel() + band.Ut.numel()
                                     + 4 * nI, 2 * macs, INT8_OPS)}
    summary["window_count"] = compare_timed(
        lambda: gt.window_count_partials(win),
        lambda: cw._window_count_plain(win.P, win.Q, win.M), 5)
    nI, _, W = win.P.shape
    nJ = win.Q.shape[2]
    bounds["window_count"] = bound(
        win.P.numel() + win.Q.numel() + win.M.numel() + 4 * nI,
        2 * nI * 128 * W * nJ, INT8_OPS)
    rng = np.random.default_rng(0)
    for W in (8, 40, 1024):
        for maps in (False, True):
            args = random_popcount_case(rng, W, maps)
            got = gt.bitdot_popcount(*args)
            want = bd._bitdot_popcount_plain(*args)
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"popcount W={W} maps={maps}: {err}")
            past = got[args[-1]:]
            assert int(past.abs().sum()) == 0, "entries past nvals not 0"
    sync()
    for name in ("tri_band_ring", "window_count"):
        err, ms, pms = summary[name]
        print(f"{tag} phase2 {name}: exact (max_abs_err {err}); "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms (Wathen 128)")
    print(f"{tag} phase2 bitdot_popcount: exact on random panels "
          f"W=8,40,1024 with/without maps")
    del L, U, band, win

    # ---- 8. the gather-dot kernel against its plain version ----
    for S in (1024, 4096):
        for dt in (torch.float32, torch.int32):
            args = random_gatherdot_case(rng, S, dt)
            err = check_gatherdot(gt.valdot_gatherdot(*args), *args)
            sync()
            print(f"{tag} phase8 valdot_gatherdot S={S} {dt}: "
                  f"{'exact' if dt == torch.int32 else 'within bound'} "
                  f"(max_abs_err {err}) on {args[2].numel()} lanes, "
                  f"nlive {args[-1]}")
    del args

    # ---- main path: 3-6, counted ----
    _build.reset_launches()

    # 3. Wathen: a dense oracle at nx=16, then the anchor at nx=128
    L, U, n, _ = wathen_lu(gt, 16)
    Ih, Jh = (np.asarray(x[:L.nvals]) for x in L._options["host_pattern"])
    A = np.zeros((n, n), np.int64)
    A[Ih, Jh] = A[Jh, Ih] = 1
    want16 = int(((A @ A) * A).sum()) // 6
    got16 = gt.tricount_auto(L, U)
    assert got16 == want16, f"Wathen 16: {got16} != oracle {want16}"
    print(f"{tag} phase3 Wathen 16: {got16} triangles == dense oracle "
          f"({gt.last_axb_method()})")
    L, U, n, nnz = wathen_lu(gt, 128)
    before = _build.launches["tri_band_ring"]
    ntri, first = timed(lambda: gt.tricount_auto(L, U))
    engine = gt.last_axb_method()
    ntri2, warm = timed(lambda: gt.tricount_auto(L, U))
    assert ntri == ntri2 == WATHEN_128_NTRI, (ntri, ntri2)
    assert engine == "cuda:tri_band_ring", engine
    assert _build.launches["tri_band_ring"] > before, "band ring not run"
    win = gt.build_window_plan(L, U, L)
    assert win is not None, "Wathen 128 window plan refused"
    wsum, wsecs = timed(
        lambda: int(gt.window_count_partials(win).sum(dtype=torch.int64)))
    assert wsum == WATHEN_128_NTRI, wsum
    print(f"{tag} phase3 Wathen 128: n {n}, {nnz} entries, {ntri} "
          f"triangles via {engine}; first {first:.4f} s, warm "
          f"{warm:.6f} s; window_count {wsum} in {wsecs:.4f} s")
    del L, U, win

    # 4. Wathen nx=384: band ring against the counting engines
    L, U, n, nnz = wathen_lu(gt, 384)
    ntri, first = timed(lambda: gt.tricount_auto(L, U))
    engine = gt.last_axb_method()
    _, warm = timed(lambda: gt.tricount_auto(L, U))
    assert engine == "cuda:tri_band_ring", engine
    band = gt.build_band_plan(L, U)
    esc, esc_first = timed(lambda: gt.tricount_esc(L, U))
    esc_engine = gt.last_axb_method()
    _, esc_warm = timed(lambda: gt.tricount_esc(L, U))
    assert ntri == esc, f"Wathen 384: band ring {ntri} != esc {esc}"
    ntri384 = ntri
    print(f"{tag} phase4 Wathen 384: n {n}, {nnz} entries, Wb {band.Wb}, "
          f"panels {band.panel_bytes} B; {ntri} triangles via {engine} "
          f"(first {first:.4f} s, warm {warm:.6f} s) == tricount_esc via "
          f"{esc_engine} (first {esc_first:.4f} s, warm {esc_warm:.6f} s)")
    del L, U, band

    # 5-6. R-MAT: the power-law regime
    plan18 = None
    graphs = {}
    for phase, scale in ((5, 16), (6, 18)):
        t0 = time.perf_counter()
        L, U, nnz, A = rmat_lu(gt, scale)
        build_s = time.perf_counter() - t0
        want_nnz, want_ntri = RMAT_ANCHORS[scale]
        assert nnz == want_nnz, f"R-MAT {scale}: nnz {nnz} != {want_nnz}"
        before = _build.launches["bitdot_popcount"]
        ntri, first = timed(lambda: gt.tricount_esc(L, U))
        engine = gt.last_axb_method()
        ntri2, warm = timed(lambda: gt.tricount_esc(L, U))
        assert ntri == ntri2 == want_ntri, (scale, ntri, ntri2)
        if engine.startswith("bitdot:"):
            assert _build.launches["bitdot_popcount"] > before, \
                f"R-MAT {scale} ran {engine} without the popcount kernel"
        print(f"{tag} phase{phase} R-MAT {scale}: nnz {nnz}, {ntri} "
              f"triangles via {engine}; graph+prep {build_s:.3f} s, first "
              f"{first:.4f} s, warm {warm:.6f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated()} B")
        if scale == 18:
            plan18 = L._options["bitdot_plan"][2]
            M18 = L
        graphs[scale] = (L, U, build_s, A)

    # 9. the masked valued product, bench.py's value recipe
    sr = gt.semiring.plus_times[gt.FP32]
    valued = {}
    for scale in (16, 18):
        L, U, build_s, _ = graphs[scale]
        n = L.nrows
        t0 = time.perf_counter()
        rng3 = np.random.default_rng(3)
        Lv, Uv, Mv = (with_values(gt, X, rng3) for X in (L, U, L))
        vals_s = time.perf_counter() - t0
        e = np.zeros(0, np.int64)
        C0 = gt.CsrMatrix.from_coo(e, e, np.zeros(0, np.float32), n, n,
                                   type=gt.FP32, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        before = _build.launches["valdot_gatherdot"]
        C, first = timed(lambda: gt.mxm(C0, Mv, None, "plus_times", Lv, Uv))
        engine = gt.last_axb_method()
        C2, warm = timed(lambda: gt.mxm(C0, Mv, None, "plus_times", Lv,
                                        Uv))
        peak = torch.cuda.max_memory_allocated()
        assert C.nvals == C2.nvals == VALUED_NNZC[scale], \
            (scale, C.nvals, C2.nvals)
        if scale == 18:
            assert engine.startswith("valdot:"), engine
        plan = vd.cached_plan(Mv, Lv, Uv, sr)
        if engine.startswith("valdot:"):
            assert plan is not None, f"R-MAT {scale}: {engine} left no plan"
            assert _build.launches["valdot_gatherdot"] > before, \
                f"R-MAT {scale} ran {engine} without the gather-dot kernel"
        Ce, esc_first = timed(lambda: gt.mxm(
            C0, Mv, None, "plus_times", Lv, Uv,
            gt.Descriptor(axb_method="gustavson")))
        esc_engine = gt.last_axb_method()
        _, esc_warm = timed(lambda: gt.mxm(
            C0, Mv, None, "plus_times", Lv, Uv,
            gt.Descriptor(axb_method="gustavson")))
        Ig, Jg, Xg = C.extractTuples()
        Ie, Je, Xe = Ce.extractTuples()
        assert np.array_equal(Ig, Ie) and np.array_equal(Jg, Je), \
            f"R-MAT {scale}: valdot and ESC patterns differ"
        np.testing.assert_allclose(Xg, Xe, rtol=5e-5, atol=1e-4)
        assert np.isfinite(Xg).all()
        hpL, hpU = L._options["host_pattern"], U._options["host_pattern"]
        flops = int(np.bincount(hpU[0][:U.nvals], minlength=n)[
            hpL[1][:L.nvals]].sum())
        lv_info = "no valdot plan"
        if plan is not None:
            lv_info = (f"plan levels {len(plan.levels)}, sum nlive "
                       f"{sum(lv.nlive for lv in plan.levels)}, covered "
                       f"lanes {plan.covered_lanes}, light lanes "
                       f"{plan.light_lanes}")
        print(f"{tag} phase9 R-MAT {scale} mxm<M> plus_times FP32: nnzC "
              f"{C.nvals} via {engine}; graph+prep {build_s:.3f} s + values "
              f"{vals_s:.3f} s, first {first:.4f} s, warm {warm:.6f} s, "
              f"{flops} flops, {flops / warm:.4g} flops/s warm; {lv_info}; "
              f"== ESC-only ({esc_engine}: first {esc_first:.4f} s, warm "
              f"{esc_warm:.6f} s); peak device memory {peak} B")
        valued[scale] = (Lv, Uv, Mv, C0, plan)
    sync()
    launches = {k: _build.launches[k] for k in MXM_PATH}
    print(f"main-path launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    path_launches = {"mxm": launches}

    # ---- 7. popcount at the main path's shapes ----
    if not isinstance(plan18, bd.BitdotPlan):
        raise AssertionError("R-MAT 18 did not build a bitdot plan")
    lv = plan18.levels[0]
    args = (plan18.Apack, plan18.Bpack, lv.amap, lv.bmap, M18.rowids,
            M18.indices, M18.nvals)
    summary["bitdot_popcount"] = compare_timed(
        lambda: gt.bitdot_popcount(*args),
        lambda: bd._bitdot_popcount_plain(*args), 5)
    err, ms, pms = summary["bitdot_popcount"]
    print(f"{tag} phase7 bitdot_popcount at R-MAT 18 level 1 (Apack "
          f"{tuple(plan18.Apack.shape)}, Bpack {tuple(plan18.Bpack.shape)}, "
          f"{M18.nzmax} entries): exact; kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms")
    live = torch.arange(M18.nzmax, device="cuda") < M18.nvals
    ar = lv.amap[M18.rowids[live].long()] if lv.amap is not None \
        else M18.rowids[live]
    bc = lv.bmap[M18.indices[live].long()] if lv.bmap is not None \
        else M18.indices[live]
    Wp = plan18.Apack.shape[1]
    nbytes = ((distinct(ar[ar >= 0]) + distinct(bc[bc >= 0])) * Wp * 4
              + M18.nzmax * 12
              + 4 * sum(x.numel() for x in (lv.amap, lv.bmap)
                        if x is not None))
    # AND, popcount and add per word of each entry
    bounds["bitdot_popcount"] = bound(nbytes, 3 * M18.nvals * Wp,
                                      CUDA32_OPS)
    sync()

    # ---- 10. the gather-dot kernel at the main path's shapes ----
    Lv, Uv, Mv, C0, plan = valued[18]
    lv = plan.levels[0]
    Av, Bv, _, _ = vd._pack_level(lv, bits=False)
    args = (Av, Bv, lv.live_ai, lv.live_bj, lv.nlive)
    err = check_gatherdot(gt.valdot_gatherdot(*args), *args)
    # the library call for the same function: cuSPARSE's sampled dense
    # product (SDDMM) over the live (ai, bj) pairs as a CSR pattern.  The
    # live lanes are mask entries in CSR order and the row maps are
    # monotone and one-to-one, so the pairs are row-sorted and unique and
    # the CSR values come out in lane order.
    S, nlive = Av.shape[1], lv.nlive
    ai, bj = lv.live_ai[:nlive].long(), lv.live_bj[:nlive].long()
    key = ai * Bv.shape[0] + bj
    assert bool((ai >= 0).all() and (bj >= 0).all()
                and (key[1:] > key[:-1]).all()), "live pairs not CSR order"
    crow = torch.searchsorted(ai, torch.arange(Av.shape[0] + 1,
                                               device="cuda"))
    pattern = torch.sparse_csr_tensor(
        crow, bj, torch.ones(nlive, device="cuda"),
        (Av.shape[0], Bv.shape[0]), check_invariants=True)
    BvT = Bv.t()

    def library():
        return torch.sparse.sampled_addmm(pattern, Av, BvT, beta=0.0)

    lib_out = torch.zeros(lv.live_ai.shape[0], device="cuda")
    lib_out[:nlive] = library().values()
    lib_err = check_gatherdot(lib_out, *args)
    ms, pms, lms = turns(lambda: gt.valdot_gatherdot(*args),
                         lambda: vd._gatherdot_plain(*args), 10, 2, library)
    summary["valdot_gatherdot"] = (err, ms, pms)
    library_ms = {"valdot_gatherdot": lms}
    bounds["valdot_gatherdot"] = bound(
        (distinct(lv.live_ai[:nlive]) + distinct(lv.live_bj[:nlive])) * S
        * 4 + nlive * 12, 2 * S * nlive, CUDA32_OPS)
    model_ns = (2 * vd._ISSUE_NS + S * 8 / vd._STREAM_BW) * 1e9
    resid = (lambda: esc_mod.csr_spgemm(sr, plan.A_light, Uv, mask=Mv))
    resid_ms = cuda_ms(resid, 3)
    print(f"{tag} phase10 valdot_gatherdot at R-MAT 18 level 1 (Av "
          f"{tuple(Av.shape)}, Bv {tuple(Bv.shape)}, nlive {nlive}): "
          f"max_abs_err {err} (within bound); kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, sampled_addmm {lms:.4f} ms (max_abs_err "
          f"{lib_err}, within bound), "
          f"bound {bounds['valdot_gatherdot'][0]:.4f} ms "
          f"({bounds['valdot_gatherdot'][1]}); {ms * 1e6 / nlive:.3f} ns "
          f"per live lane (cost model {model_ns:.1f}); ESC residual "
          f"{resid_ms:.4f} ms for {plan.light_lanes} lanes, "
          f"{resid_ms * 1e6 / max(plan.light_lanes, 1):.3f} ns per lane "
          f"(cost model {vd._ESC_NS * 1e9:.1f})")
    # where the warm R-MAT 18 mxm goes: every slab's gather-dot, the
    # slab pass with its merges, the whole engine (+ the residual and
    # the combine), and the whole mxm (+ the accum/mask epilogue)
    k4_all = cuda_ms(lambda: [gt.valdot_gatherdot(
        *vd._pack_level(v, bits=False)[:2], v.live_ai, v.live_bj, v.nlive)
        for v in plan.levels], 3)
    heavy = cuda_ms(lambda: vd._valdot_heavy(plan, sr, Mv), 3)
    engine = cuda_ms(lambda: vd.valdot_masked_spgemm(sr, Lv, Uv, Mv), 3)
    whole = cuda_ms(lambda: gt.mxm(C0, Mv, None, "plus_times", Lv, Uv), 3)
    print(f"{tag} phase10 R-MAT 18 warm mxm breakdown (CUDA events, ms): "
          f"gather-dot over {len(plan.levels)} slabs {k4_all:.4f}; slab "
          f"pass with merges {heavy:.4f}; residual ESC {resid_ms:.4f}; "
          f"combine {engine - heavy - resid_ms:.4f}; valdot engine "
          f"{engine:.4f}; epilogue {whole - engine:.4f}; mxm {whole:.4f}")
    sync()

    # ---- 11. the BSR SpMV kernel (K5) at the Wathen 256 plan ----
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain bmm: f32
    t0 = time.perf_counter()
    I, J, X, n = gt.wathen_coo(256, 256, seed=1)
    W = gt.CsrMatrix.from_coo(I, J, X, n, n, type=gt.FP32, device="cuda")
    wbuild = time.perf_counter() - t0
    del I, J, X
    plan, plan_s = timed(lambda: cs.bsr_spmv_plan(W))
    assert (n, W.nvals, plan.ntiles) == WATHEN_256, \
        (n, W.nvals, plan.ntiles)
    xw = torch.from_numpy(np.random.default_rng(11).standard_normal(n)
                          .astype(np.float32)).to("cuda")
    T = plan.tiles.shape[1]
    xpad = torch.zeros(plan.ncb * T, device="cuda")
    xpad[:n] = xw
    degW = W.indptr[1:] - W.indptr[:-1]
    err = spmv_error(cs.bsr_spmv_tiles(plan, xpad), plan, xpad, degW)
    # the library call for the same function: cuSPARSE's BSR SpMV over the
    # plan's valid tiles (their slots are 0..ntiles-1 in triple order)
    valid = plan.valid.bool()
    crow = torch.zeros(plan.nrb + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.bincount(plan.rb[valid].long(),
                              minlength=plan.nrb).cumsum(0)
    bsr = torch.sparse_bsr_tensor(crow, plan.cb[valid].long(), plan.tiles,
                                  (plan.nrb * T, plan.ncb * T),
                                  check_invariants=True)

    def bsr_library():
        return bsr @ xpad

    lib_err = spmv_error(bsr_library(), plan, xpad, degW)
    ms, pms, lms = turns(lambda: cs.bsr_spmv_tiles(plan, xpad),
                         lambda: cs._bsr_spmv_plain(plan, xpad), 20, 5,
                         bsr_library)
    summary["bsr_spmv"] = (err, ms, pms)
    library_ms["bsr_spmv"] = lms
    ntrip = plan.rb.numel()
    bounds["bsr_spmv"] = bound(
        plan.tiles.numel() * 4 + 12 * ntrip + 4 * (plan.nrb + 1)
        + 4 * xpad.numel() + 4 * plan.nrb * T, 2 * plan.ntiles * T * T,
        CUDA32_OPS)
    print(f"{tag} phase11 bsr_spmv at Wathen 256 (n {n}, nnz {W.nvals}, "
          f"{plan.ntiles} tiles, {ntrip} triples, {plan.nrb} row-blocks; "
          f"graph {wbuild:.3f} s, plan {plan_s:.3f} s): max_abs_err {err} "
          f"(within bound); kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"torch.sparse_bsr_tensor @ x {lms:.4f} ms (max_abs_err "
          f"{lib_err}, within bound), bound "
          f"{bounds['bsr_spmv'][0]:.4f} ms ({bounds['bsr_spmv'][1]})")
    del bsr
    # the gate's tile budget at the next Wathen size: nx=ny=384 needs
    # more than MAX_TILE_BYTES of tiles, so its mxv takes the dense-x
    # engine (reckoned from the triplets; nothing is built)
    I, J, _, n384 = gt.wathen_coo(384, 384, seed=1)
    ncb384 = -(-n384 // T)
    nt384 = len(np.unique((I // T) * ncb384 + J // T))
    assert nt384 * T * T * 4 > cs.MAX_TILE_BYTES, nt384
    print(f"{tag} phase11 Wathen 384 (n {n384}): {nt384} tiles, "
          f"{nt384 * T * T * 4} B of tiles > MAX_TILE_BYTES "
          f"{cs.MAX_TILE_BYTES}: the gate refuses it")
    del I, J
    sync()

    # ---- SpMV path: 12-13, counted ----
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # 12. Wathen 256: mxv through the tile kernel, checked two ways; the
    # first call builds the BSR plan anew (phase 11's is dropped)
    del plan, xpad
    for key in [k for k in W._options if isinstance(k, tuple)
                and k[0] in ("_bsr_spmv_plan", "_bsr_spmv_ok")]:
        del W._options[key]
    u = gt.Vector.from_dense(xw)
    w0 = gt.Vector.new(gt.FP32, n, device="cuda")

    def mxv_w():
        return gt.mxv(w0, None, None, "plus_times", W, u)

    wv, first = timed(mxv_w)
    engine = gt.last_axb_method()
    _, warm = timed(mxv_w)
    assert engine == "cuda:bsr_spmv", engine
    assert _build.launches["bsr_spmv"] > 0, "mxv did not launch K5"
    y = wv.to_dense()
    werr, tol = scipy_check(y, wv.pattern_np(), W, xw)
    srf = gt.semiring.plus_times[gt.FP32]
    k5_engine_ms = cuda_ms(lambda: gt.csr_mxv(srf, W, xw), 20)
    k5_mxv_ms = cuda_ms(mxv_w, 20)
    W._options["bsr_spmv"] = False
    wd, dfirst = timed(mxv_w)
    dengine = gt.last_axb_method()
    assert dengine == "spmv:dense_x", dengine
    assert np.array_equal(wd.pattern_np(), wv.pattern_np())
    dd = np.abs(wd.to_dense().astype(np.float64) - y)
    assert (dd <= 2 * tol).all(), f"K5 vs dense-x: {dd.max()}"
    dx_engine_ms = cuda_ms(lambda: gt.csr_mxv(srf, W, xw), 20)
    dx_mxv_ms = cuda_ms(mxv_w, 20)
    W._options["bsr_spmv"] = None
    wt, vsecs = timed(lambda: gt.vxm(w0, None, None, "plus_times", u, W,
                                     gt.TRAN1))
    vengine = gt.last_axb_method()
    verr, _ = scipy_check(wt.to_dense(), wt.pattern_np(), W, xw)
    # a u with one inf: the tile kernel is refused, and only the rows
    # that read the inf entry leave the finite range
    xinf = xw.clone()
    xinf[n // 2] = float("inf")
    wi = gt.mxv(w0, None, None, "plus_times", W, gt.Vector.from_dense(xinf))
    iengine = gt.last_axb_method()
    assert iengine == "spmv:dense_x", iengine
    hpW = W._options["host_pattern"]
    reads = np.zeros(n, bool)
    reads[hpW[0][:W.nvals][hpW[1][:W.nvals] == n // 2]] = True
    yi = wi.to_dense()
    assert np.isfinite(yi[~reads]).all() and not np.isfinite(yi[reads]).any()
    print(f"{tag} phase12 Wathen 256 mxv plus_times FP32 via {engine}: "
          f"first {first:.6f} s, warm {warm:.6f} s; max_abs_err vs scipy "
          f"float64 {werr} (within bound); CUDA events per call: engine "
          f"(csr_mxv) K5 {k5_engine_ms:.4f} ms vs dense-x "
          f"{dx_engine_ms:.4f} ms, whole mxv {k5_mxv_ms:.4f} ms vs "
          f"{dx_mxv_ms:.4f} ms; dense-x ({dengine}) first {dfirst:.6f} s, "
          f"max |K5 - dense-x| {dd.max()} (within 2x bound); vxm TRAN1 via "
          f"{vengine} {vsecs:.6f} s, max_abs_err vs scipy {verr}; u with "
          f"one inf via {iengine}: {int(reads.sum())} rows non-finite, the "
          f"rest finite")

    # 13. R-MAT 18: dense mxv, one frontier step, BFS, PageRank
    A18 = graphs[18][3]
    n18 = A18.nrows
    x18 = torch.from_numpy(np.random.default_rng(13).random(n18)
                           .astype(np.float32)).to("cuda")
    u18 = gt.Vector.from_dense(x18)
    w18 = gt.Vector.new(gt.FP32, n18, device="cuda")

    def mxv_r():
        return gt.mxv(w18, None, None, "plus_times_fp32", A18, u18)

    r18, rfirst = timed(mxv_r)
    rengine = gt.last_axb_method()
    _, rwarm = timed(mxv_r)
    assert rengine == "spmv:dense_x", rengine
    rerr, _ = scipy_check(r18.to_dense(), r18.pattern_np(), A18, x18)
    q = gt.Vector.from_coo([0], [True], n18, type=gt.BOOL, device="cuda")
    # A18 is symmetric, so u'A' (TRAN1, no host resort) is u'A
    step_desc = gt.Descriptor(mask_scmp=True, replace=True, tran1=True)

    def frontier_step():
        return gt.vxm(gt.Vector.new(gt.BOOL, n18, device="cuda"), q, None,
                      "lor_land", q, A18, step_desc)

    wq, qfirst = timed(frontier_step)
    qengine = gt.last_axb_method()
    _, qwarm = timed(frontier_step)
    assert qengine == "spmv:sparse_x", qengine
    hp = A18._options["host_pattern"]
    nbrs = hp[1][:A18.nvals][hp[0][:A18.nvals] == 0]
    nbrs = np.unique(nbrs[nbrs != 0])
    assert np.array_equal(np.nonzero(wq.pattern_np())[0], nbrs)
    assert wq.to_dense()[nbrs].all()
    lev, bfs_first = timed(lambda: gt.bfs_csr(A18, 0))
    _, bfs_warm = timed(lambda: gt.bfs_csr(A18, 0))
    vals, cnts = np.unique(lev, return_counts=True)
    levels = dict(zip(vals.tolist(), cnts.tolist()))
    assert levels == RMAT18_BFS_LEVELS, levels
    pr, pr_first = timed(lambda: gt.pagerank_csr(A18, iters=20))
    _, pr_warm = timed(lambda: gt.pagerank_csr(A18, iters=20))
    top = np.argsort(-pr, kind="stable")[:10].tolist()
    assert top == RMAT18_PAGERANK_TOP10, top
    assert np.isfinite(pr).all() and abs(float(pr.sum()) - 1.0) < 1e-5
    # PageRank's split: set-up and read-back alone (0 steps), 20 steps
    pr0_ms = cuda_ms(lambda: gt.pagerank_csr(A18, iters=0), 3)
    pr20_ms = cuda_ms(lambda: gt.pagerank_csr(A18, iters=20), 3)
    sync()
    print(f"{tag} phase13 R-MAT 18 (n {n18}, nnz {A18.nvals}): mxv "
          f"plus_times FP32 via {rengine} first {rfirst:.6f} s, warm "
          f"{rwarm:.6f} s, max_abs_err vs scipy {rerr} (within bound); "
          f"frontier vxm lor_land via {qengine}: {len(nbrs)} neighbours, "
          f"first {qfirst:.6f} s, warm {qwarm:.6f} s; bfs_csr levels "
          f"{levels} ({n18 - levels[0]} reached) first {bfs_first:.4f} s, "
          f"warm {bfs_warm:.4f} s; pagerank_csr(20) top-10 {top} first "
          f"{pr_first:.4f} s, warm {pr_warm:.4f} s (CUDA events: 0 steps "
          f"{pr0_ms:.4f} ms, 20 steps {pr20_ms:.4f} ms); peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    spmv_launches = {k: _build.launches[k] for k in SPMV_PATH}
    print(f"spmv-path launches: {json.dumps(spmv_launches)}")
    missing = [k for k, v in spmv_launches.items() if v == 0]
    assert not missing, f"kernels not launched on the SpMV path: {missing}"
    path_launches["spmv"] = spmv_launches

    # ---- 14. the tropical kernel (K6) against its plain version ----
    from graphblas_tpu_torch.sparse import cuda_tropical as ct
    rng = np.random.default_rng(14)
    a, b = with_specials(rng, (1000, 1100)), with_specials(rng, (1100, 900))
    for add, mult in ct.TROPICAL_PAIRS:
        tropical_err(ct.tropical_mm(a, b, add, mult),
                     ct._tropical_mm_plain(a, b, add, mult))
    sync()
    print(f"{tag} phase14 tropical_mm: all six pairs at (1000x1100).(1100x"
          f"900) with +-inf and NaN values equal their plain version (up to "
          f"the sign of zero, NaN where NaN)")
    N = 4096
    a = torch.from_numpy(1 + 9 * rng.random((N, N), np.float32)).to("cuda")
    b = torch.from_numpy(1 + 9 * rng.random((N, N), np.float32)).to("cuda")

    def k6():
        return ct.tropical_mm(a, b, "MIN", "PLUS")

    k1 = cuda_ms(k6, 5)
    want, pms = cuda_once(lambda: ct._tropical_mm_plain(a, b, "MIN", "PLUS"))
    k2 = cuda_ms(k6, 5)
    err = tropical_err(k6(), want)
    summary["tropical_mm"] = (err, min(k1, k2), pms)
    bounds["tropical_mm"] = bound(3 * N * N * 4, 2 * N ** 3, CUDA32_OPS)
    print(f"{tag} phase14 tropical_mm min-plus at {N}^3: equal to plain; "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain (once) {pms:.4f} ms, bound "
          f"{bounds['tropical_mm'][0]:.4f} ms "
          f"({bounds['tropical_mm'][1]}; counts an add and a min at the "
          f"float32 FMA rate, so optimistic), "
          f"{2 * N ** 3 / (min(k1, k2) * 1e-3) / 1e12:.3f} T ops/s")
    del a, b, want

    # ---- 15. the window product kernel (K3) against its plain version ----
    L, U, _, _ = wathen_lu(gt, 128)
    win = gt.build_window_plan(L, U, L)
    assert win is not None, "Wathen 128 window plan refused"
    Ph, Qh = win.P.half(), win.Q.half()

    def bmm_library():
        return torch.bmm(Ph, Qh)

    got = gt.window_masked_mm_pallas(win)
    lib_masked = bmm_library().to(torch.int32) * win.M
    assert torch.equal(lib_masked, got), "float16 bmm (masked) != K3"
    err = max_abs_err(got, cw._window_mm_plain(win.P, win.Q, win.M))
    assert err == 0, f"K3 differs from its plain version by {err}"
    ms, pms, lms = turns(lambda: gt.window_masked_mm_pallas(win),
                         lambda: cw._window_mm_plain(win.P, win.Q, win.M),
                         10, 3, bmm_library)
    summary["window_mm"] = (err, ms, pms)
    library_ms["window_mm"] = lms
    nI, _, W = win.P.shape
    nJ = win.Q.shape[2]
    bounds["window_mm"] = bound(
        win.P.numel() + win.Q.numel() + win.M.numel() + 4 * got.numel(),
        2 * nI * 128 * W * nJ, INT8_OPS)
    print(f"{tag} phase15 window_mm at Wathen 128 (P {tuple(win.P.shape)}, "
          f"Q {tuple(win.Q.shape)}): exact; kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, torch.bmm float16 (unmasked) {lms:.4f} ms, bound "
          f"{bounds['window_mm'][0]:.4f} ms ({bounds['window_mm'][1]})")
    del L, U, win, Ph, Qh, got, lib_masked
    sync()

    # ---- bitmap mxm path: 16, counted ----
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # 16a. all-pairs shortest paths on R-MAT 12 by min-plus squaring
    from scipy.sparse.csgraph import shortest_path
    D, G = apsp_d0(gt, 12)
    n12 = D.nrows
    minf = gt.binary.min[gt.FP32]
    secs = []
    for products in range(1, 13):
        Dn, sec = timed(lambda: gt.mxm(D, None, minf, "min_plus", D, D))
        engine = gt.last_axb_method()
        assert engine == "cuda:tropical_min_plus", engine
        secs.append(sec)
        same = (torch.equal(Dn.pattern, D.pattern)
                and torch.equal(Dn.values, D.values))
        D = Dn
        if same:
            break
    assert same, "min-plus squaring did not converge in 12 products"
    ref = shortest_path(G, method="D", directed=False)
    pat = D.pattern_np()
    assert np.array_equal(pat, np.isfinite(ref)), "APSP reachability"
    dist = D.to_dense()
    np.testing.assert_allclose(dist[pat], ref[pat], rtol=1e-5)
    derr = float(np.abs(dist[pat] - ref[pat]).max())
    print(f"{tag} phase16 APSP R-MAT 12 (n {n12}, {G.nnz} edges): "
          f"{products} min-plus products via {engine} (the last one "
          f"changes nothing), first {secs[0]:.4f} s, warm "
          f"{min(secs[1:]):.4f}-{max(secs[1:]):.4f} s per product; "
          f"{int(pat.sum())} reachable pairs == scipy, max |error| "
          f"{derr:.3g} (rtol 1e-5)")
    del D, Dn, G, ref, dist, pat

    # 16b. one SpMM on the R-MAT 18 graph: C = A X into a bitmap
    X = torch.from_numpy(np.random.default_rng(16).random((n18, 32),
                                                          np.float32))
    X = X.to("cuda")
    B = gt.Matrix.from_dense(X)
    C0 = gt.Matrix.new(gt.FP32, n18, 32, device="cuda")
    srf = gt.semiring.plus_times[gt.FP32]
    C, sfirst = timed(lambda: gt.mxm(C0, None, None, srf, A18, B))
    sengine = gt.last_axb_method()
    assert sengine == "spmm:ell", sengine
    _, swarm = timed(lambda: gt.mxm(C0, None, None, srf, A18, B))
    smm_ms = cuda_ms(lambda: gt.mxm(C0, None, None, srf, A18, B), 3)
    serr, _ = scipy_check(C.to_dense(), C.pattern_np(), A18, X)
    print(f"{tag} phase16 SpMM R-MAT 18 (n {n18}, nnz {A18.nvals}) x X "
          f"({n18}, 32) plus_times FP32 via {sengine}: first {sfirst:.4f} s "
          f"(plan built), warm {swarm:.6f} s ({smm_ms:.4f} ms CUDA events); "
          f"max_abs_err vs scipy {serr:.3g} (within bound)")
    del X, B, C0, C

    # 16c. the window product panels on the Wathen 128 window plan
    L, U, _, _ = wathen_lu(gt, 128)
    win = gt.build_window_plan(L, U, L)
    panels, wsecs = timed(lambda: gt.window_masked_mm_pallas(win))
    wengine = gt.last_axb_method()
    wtotal = int(panels.sum(dtype=torch.int64))
    assert wengine == "cuda:window_mm", wengine
    assert wtotal == WATHEN_128_NTRI, wtotal
    print(f"{tag} phase16 window_masked_mm_pallas Wathen 128 via {wengine}: "
          f"panels {tuple(panels.shape)} sum to {wtotal} in {wsecs:.4f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated()} B")
    del L, U, win, panels
    sync()
    bitmap_launches = {k: _build.launches[k] for k in BITMAP_PATH}
    print(f"bitmap-mxm-path launches: {json.dumps(bitmap_launches)}")
    missing = [k for k, v in bitmap_launches.items() if v == 0]
    assert not missing, \
        f"kernels not launched on the bitmap mxm path: {missing}"
    path_launches["bitmap_mxm"] = bitmap_launches

    # ---- 17. the BSR tile-triple kernel (K7) against its plain version ----
    from graphblas_tpu_torch.sparse import bsr as bsr_mod
    from graphblas_tpu_torch.sparse import cuda_bsr as tcb
    Lt, Bt, _, _, _ = wathen_tiles(gt, 128)
    args, sched = k7_schedule(tcb, Lt, Lt, Bt)
    got = tcb.bsr_tiles_mm(*args, Lt.tiles, Bt.tiles, Lt.tiles, torch.int32)
    k7_err = max_abs_err(got, tcb._bsr_mm_plain(*args, Lt.tiles, Bt.tiles,
                                                Lt.tiles, torch.int32))
    assert k7_err == 0, \
        f"K7 counting differs from its plain version by {k7_err}"
    assert int(got.sum(dtype=torch.int64)) == WATHEN_128_NTRI
    sync()
    print(f"{tag} phase17 bsr_masked_mm counting at Wathen 128 ({Lt.ntiles} "
          f"L tiles, {len(sched[1])} triples, kmax {sched[4]}): exact, "
          f"sum {WATHEN_128_NTRI}")
    # values at Wathen 64: bench.py's values, L then U
    Lt64, _, iu, ju, n64 = wathen_tiles(gt, 64)
    lo, up = iu > ju, iu < ju
    rng3 = np.random.default_rng(3)
    dense = {}
    for name, sel in (("L", lo), ("U", up)):
        v = torch.zeros((n64, n64), device="cuda")
        p = torch.zeros((n64, n64), dtype=torch.bool, device="cuda")
        ii = torch.from_numpy(iu[sel]).to("cuda")
        jj = torch.from_numpy(ju[sel]).to("cuda")
        v[ii, jj] = torch.from_numpy(
            rng3.random(int(sel.sum())).astype(np.float32) + 0.5).to("cuda")
        p[ii, jj] = True
        dense[name] = (v, p)
    Av = gt.tile_matrix(*dense["L"])
    Bv = gt.tile_matrix(dense["U"][0].T, dense["U"][1].T)
    del dense
    vargs, vsched = k7_schedule(tcb, Lt64, Av, Bv)
    K = 128 * vsched[4]

    def k7_values(at):
        got = tcb.bsr_tiles_mm(*vargs, at, Bv.tiles, Lt64.tiles,
                               torch.float32)
        want = tcb._bsr_mm_plain(*vargs, at.double(), Bv.tiles.double(),
                                 Lt64.tiles, torch.float64)
        fin = torch.where(torch.isfinite(at), at, 0).double().abs()
        mag = tcb._bsr_mm_plain(*vargs, fin, Bv.tiles.double().abs(),
                                Lt64.tiles, torch.float64)
        return values_err(got, want, mag, K), got

    verr, _ = k7_values(Av.tiles)
    ainf = Av.tiles.clone()
    first = torch.nonzero(ainf[0])[0]
    ainf[0, first[0], first[1]] = float("inf")
    ierr, gi = k7_values(ainf)
    values_err_of = {"bsr_masked_mm": max(verr, ierr)}
    sync()
    print(f"{tag} phase17 bsr_masked_mm values at Wathen 64 ({Av.ntiles} "
          f"tiles, {len(vsched[1])} triples): max_abs_err {verr} (within "
          f"K 2^-24 sum|ab|, K = {K}); with one +inf: "
          f"{int(torch.isinf(gi).sum())} inf, {int(torch.isnan(gi).sum())} "
          f"NaN entries as in the plain version, the rest within bound "
          f"(max_abs_err {ierr})")
    del Av, Bv, ainf, gi, Lt64
    # timing at Wathen 384 (the phase-4 graph)
    Lt, Bt, _, _, _ = wathen_tiles(gt, 384)
    args, sched = k7_schedule(tcb, Lt, Lt, Bt)
    nout = len(sched[3])
    counts = torch.from_numpy(np.diff(sched[0]).astype(np.int64)).cuda()
    oid = torch.repeat_interleave(torch.arange(nout, device="cuda"), counts)
    ta_l, tb_l = args[1].long(), args[2].long()

    def k7():
        return tcb.bsr_tiles_mm(*args, Lt.tiles, Bt.tiles, Lt.tiles,
                                torch.int32)

    def k7_library():
        return bsr_mod._product_counts(Lt.tiles, Bt.tiles, ta_l, tb_l, oid,
                                       nout)

    def k7_plain():
        return tcb._bsr_mm_plain(*args, Lt.tiles, Bt.tiles, Lt.tiles,
                                 torch.int32)

    got = k7()
    assert int(got.sum(dtype=torch.int64)) == ntri384
    k7_err = max(k7_err, max_abs_err(got, k7_plain()))
    assert k7_err == 0, \
        f"K7 counting differs from its plain version by {k7_err}"
    masked = k7_library() * (Lt.tiles[args[3].long()] != 0)
    assert torch.equal(masked, got), "float16 bmm (masked) != K7"
    del masked
    ms, pms, lms = turns(k7, k7_plain, 20, 2, k7_library)
    summary["bsr_masked_mm"] = (k7_err, ms, pms)
    library_ms["bsr_masked_mm"] = lms
    # A and M are one stack here (L's tiles): each is read once
    bounds["bsr_masked_mm"] = k7_bound(sched, 1, 4, a_is_m=True)
    print(f"{tag} phase17 bsr_masked_mm at Wathen 384 ({Lt.ntiles} L tiles, "
          f"{nout} outputs, {len(sched[1])} triples, kmax {sched[4]}): "
          f"exact against its plain version and equal to phase 4's count; "
          f"kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"float16 bmm + index_add_ {lms:.4f} ms (equal to K7 once "
          f"masked), bound {bounds['bsr_masked_mm'][0]:.4f} ms "
          f"({bounds['bsr_masked_mm'][1]})")
    # the values form on the same schedule: 0/1 float32 tiles sum exactly
    Af, Bf = Lt.tiles.float(), Bt.tiles.float()

    def k7f():
        return tcb.bsr_tiles_mm(*args, Af, Bf, Lt.tiles, torch.float32)

    assert torch.equal(k7f(), got.float()), "K7 values form != counts"
    fms = min(cuda_ms(k7f, 10), cuda_ms(k7f, 10))
    fbound = k7_bound(sched, 4, 4, CUDA32_OPS)
    print(f"{tag} phase17 bsr_masked_mm values form at Wathen 384 (0/1 "
          f"float32 tiles, equal to the counts): kernel {fms:.4f} ms, bound "
          f"{fbound[0]:.4f} ms ({fbound[1]}, float32 FMAs at "
          f"{CUDA32_OPS / 1e12:.0f} T/s)")
    del Lt, Bt, Af, Bf, args, got, oid
    sync()

    # ---- 18. the probes' kernels against their plain versions ----
    from graphblas_tpu_torch.tools import gather_probe as gp
    from graphblas_tpu_torch.tools import gatherdot_probe as gdp
    R, Wx = 1 << 15, 128
    x, idx = gp._case(R, Wx, Wx)
    err = max_abs_err(gp.row_gather(x, idx), gp._row_gather_plain(x, idx))
    assert err == 0, f"row_gather differs from take_along_dim by {err}"
    idx_l = idx.long()
    ms, pms, lms = turns(lambda: gp.row_gather(x, idx),
                         lambda: gp._row_gather_plain(x, idx), 50, 50,
                         lambda: torch.take_along_dim(x, idx_l, 1))
    summary["row_gather"] = (err, ms, pms)
    library_ms["row_gather"] = lms
    bounds["row_gather"] = bound(3 * R * Wx * 4, R * Wx, CUDA32_OPS)
    take = gp.probe_scalar_gather()
    print(f"{tag} phase18 row_gather (P1) at {R} rows x {Wx}: exact; kernel "
          f"{ms:.4f} ms ({R * Wx / (ms * 1e6):.2f} G gathers/s, "
          f"{3 * R * Wx * 4 / (ms * 1e6):.1f} GB/s), plain {pms:.4f} ms, "
          f"torch.take_along_dim {lms:.4f} ms, bound "
          f"{bounds['row_gather'][0]:.4f} ms ({bounds['row_gather'][1]}); "
          f"torch.take {take['E']} of {take['n']}: {take['ms']:.4f} ms "
          f"({take['g_per_s']:.2f} G gathers/s)")
    del x, idx, idx_l
    A, B, ai, bj = gdp.make_tables("cuda")
    ref = gdp._gatherdot_async_plain(A.double(), B.double(), ai, bj)
    tol = gdp.S * 2.0 ** -24 * ref
    errs = {}
    # the library call: cuSPARSE's SDDMM over the distinct pairs as a CSR
    # pattern (sorted by row), read back in pair order
    key, inv = torch.unique(ai.long() * gdp.NA + bj.long(),
                            return_inverse=True)
    crow = torch.searchsorted(key // gdp.NA,
                              torch.arange(gdp.NA + 1, device="cuda"))
    pairs = torch.sparse_csr_tensor(
        crow, key % gdp.NA, torch.ones(key.numel(), device="cuda"),
        (gdp.NA, gdp.NA), check_invariants=True)
    Bt_ = B.t()
    forms = {"gatherdot_async": lambda: gdp.gatherdot_async(A, B, ai, bj),
             "plain": lambda: gdp._gatherdot_async_plain(A, B, ai, bj),
             "valdot_k4": lambda: gt.valdot_gatherdot(A, B, ai, bj, gdp.E),
             "sampled_addmm": lambda: torch.sparse.sampled_addmm(
                 pairs, A, Bt_, beta=0.0)}
    for name, fn in forms.items():
        got = fn()
        if name == "sampled_addmm":
            got = got.values()[inv]
        e = (got.double() - ref).abs()
        if bool((e > tol).any()):
            raise AssertionError(f"{name} beyond the bound: {e.max()}")
        errs[name] = float(e.max())
    k4a = cuda_ms(forms["valdot_k4"], 20)
    ms, pms, lms = turns(forms["gatherdot_async"], forms["plain"], 20, 5,
                         forms["sampled_addmm"])
    k4ms = min(k4a, cuda_ms(forms["valdot_k4"], 20))
    summary["gatherdot_async"] = (errs["gatherdot_async"], ms, pms)
    library_ms["gatherdot_async"] = lms
    rows = 2 * gdp.E * gdp.S * 4
    bounds["gatherdot_async"] = bound(
        (distinct(ai) + distinct(bj)) * gdp.S * 4 + gdp.E * 12,
        2 * gdp.S * gdp.E, CUDA32_OPS)
    print(f"{tag} phase18 gatherdot_async (P2) at NA {gdp.NA}, S {gdp.S}, "
          f"E {gdp.E}: within bound (max_abs_err "
          f"{errs['gatherdot_async']}); cp.async ring {ms:.4f} ms "
          f"({rows / (ms * 1e6):.1f} GB/s of gathered rows), K4 "
          f"(synchronous loads) {k4ms:.4f} ms ({rows / (k4ms * 1e6):.1f} "
          f"GB/s), plain {pms:.4f} ms ({rows / (pms * 1e6):.1f} GB/s), "
          f"sampled_addmm {lms:.4f} ms ({key.numel()} distinct pairs), bound "
          f"{bounds['gatherdot_async'][0]:.4f} ms "
          f"({bounds['gatherdot_async'][1]})")
    del A, B, Bt_, ai, bj, ref, tol, pairs, key, inv
    sync()

    # ---- the tile engine, k-truss and the probes: 19, counted ----
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # 19a. the count through bsr_masked_count_pallas from COO tiles
    for nx, want in ((128, WATHEN_128_NTRI), (384, ntri384)):
        (Lt, Bt, _, _, _), tsecs = timed(lambda: wathen_tiles(gt, nx))
        (C, _), first = timed(lambda: gt.bsr_masked_count_pallas(Lt, Lt, Bt))
        got = int(C.sum(dtype=torch.int64))
        _, warm = timed(lambda: gt.bsr_masked_count_pallas(Lt, Lt, Bt))
        dev_ms = cuda_ms(lambda: gt.bsr_masked_count_pallas(Lt, Lt, Bt), 3)
        assert got == want, f"Wathen {nx} through K7: {got} != {want}"
        print(f"{tag} phase19 bsr_masked_count_pallas Wathen {nx}: {got} "
              f"triangles; graph + tiles from COO {tsecs:.4f} s, first "
              f"{first:.4f} "
              f"s, warm {warm:.4f} s ({dev_ms:.4f} ms CUDA events, the "
              f"host schedule included)")
        del Lt, Bt, C
    # 19b. tricount_bsr_pallas on the Wathen 16 patterns
    L, U, n, _ = wathen_lu(gt, 16)
    P = np.zeros((n, n), bool)
    P[Ih, Jh] = True
    got = gt.tricount_bsr_pallas(P, P.T)
    assert got == want16, f"tricount_bsr_pallas Wathen 16: {got} != {want16}"
    print(f"{tag} phase19 tricount_bsr_pallas Wathen 16: {got} == dense "
          f"oracle")
    # 19c. masked_mxm(L, L, U) on Wathen 64 in its four modes
    L, U, n, _ = wathen_lu(gt, 64)
    ntri64 = gt.tricount_auto(L, U)
    rng3 = np.random.default_rng(3)
    Lv, Uv = with_values(gt, L, rng3), with_values(gt, U, rng3)
    S_ = gt.semiring
    modes = (("count_structural", None, S_.plus_pair[gt.INT32]),
             ("count_truthy", S_.plus_land[gt.INT32], S_.plus_land[gt.INT32]),
             ("bool", S_.lor_land[gt.BOOL], S_.lor_land[gt.BOOL]),
             ("values", S_.plus_times[gt.FP32], S_.plus_times[gt.FP32]))
    for mode, sr, ref_sr in modes:
        C, first = timed(lambda: gt.masked_mxm(Lv, Lv, Uv, semiring=sr))
        engine = gt.last_axb_method()
        _, warm = timed(lambda: gt.masked_mxm(Lv, Lv, Uv, semiring=sr))
        want = gt.mxm(gt.Matrix.new(ref_sr.ztype, n, n, device="cuda"), Lv,
                      None, ref_sr, Lv, Uv)
        assert engine == ("cuda:bsr_values" if mode == "values"
                          else "cuda:bsr_count"), engine
        assert torch.equal(C.pattern, want.pattern), f"{mode}: pattern"
        if mode == "values":
            np.testing.assert_allclose(C.to_dense(), want.to_dense(),
                                       rtol=1e-5, atol=1e-4)
            assert np.isfinite(C.to_dense()).all()
        else:
            assert torch.equal(C.values, want.values.to(C.values.dtype)), \
                f"{mode}: values"
        if mode == "count_structural":
            assert int(C.values.sum(dtype=torch.int64)) == ntri64
        print(f"{tag} phase19 masked_mxm Wathen 64 (n {n}) {mode} via "
              f"{engine}: {int(C.pattern.sum())} entries == mxm with the "
              f"same mask; first {first:.4f} s, warm {warm:.4f} s")
    del C, want, Lv, Uv, L, U
    # 19d. k-truss on the symmetrized R-MAT graphs
    for scale in (16, 18):
        k, want_e, want_s = KTRUSS_ANCHORS[scale]
        A = graphs[scale][3]
        before = _build.launches["bitdot_popcount"]
        (truss, sup, steps), secs = timed(lambda: gt.ktruss_esc(A, k))
        engine = gt.last_axb_method()
        assert engine == "bitdot:ktruss_incremental", engine
        assert _build.launches["bitdot_popcount"] > before, \
            f"R-MAT {scale} k-truss without the popcount kernel"
        assert (truss.nvals // 2, steps) == (want_e, want_s), \
            (scale, truss.nvals, steps)
        assert int(sup[:truss.nvals].min()) >= k - 2
        print(f"{tag} phase19 ktruss_esc R-MAT {scale} k={k}: "
              f"{truss.nvals // 2} edges ({truss.nvals} entries) in {steps} "
              f"sweeps via {engine}, {secs:.3f} s (plan included), "
              f"{_build.launches['bitdot_popcount'] - before} popcount "
              f"launches")
        if scale == 16:
            k5 = truss.nvals // 2
        del truss, sup
    allk, secs = timed(lambda: gt.allktruss_esc(graphs[16][3], kmax=5))
    assert sorted(allk) == [3, 4, 5] and allk[5]["nedges"] == k5, allk
    print(f"{tag} phase19 allktruss_esc R-MAT 16 to k=5: {allk} in "
          f"{secs:.3f} s")
    # 19e. the probes through their entry points
    for probe in (gp, gdp):
        recs, secs = timed(probe.run)
        print(f"{tag} phase19 {probe.__name__}.run: {len(recs)} records "
              f"in {secs:.3f} s")
    sync()
    print(f"{tag} phase19 peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    bsr_launches = {k: _build.launches[k] for k in BSR_PATH}
    print(f"bsr-ktruss-probe-path launches: {json.dumps(bsr_launches)}")
    missing = [k for k, v in bsr_launches.items() if v == 0]
    assert not missing, \
        f"kernels not launched on the tile-engine path: {missing}"
    path_launches["bsr_ktruss_probes"] = bsr_launches

    sources = {
        "tri_band_ring": ("graphblas_tpu_torch/csrc/window.cu",
                          "graphblas_tpu/sparse/pallas_window.py:160"),
        "window_count": ("graphblas_tpu_torch/csrc/window.cu",
                         "graphblas_tpu/sparse/pallas_window.py:63"),
        "bitdot_popcount": ("graphblas_tpu_torch/csrc/bitdot.cu",
                            "graphblas_tpu/sparse/bitdot.py:401"),
        "valdot_gatherdot": ("graphblas_tpu_torch/csrc/valdot.cu",
                             "graphblas_tpu/sparse/valdot.py:481"),
        "bsr_spmv": ("graphblas_tpu_torch/csrc/spmv.cu",
                     "graphblas_tpu/sparse/pallas_spmv.py:103"),
        "window_mm": ("graphblas_tpu_torch/csrc/window.cu",
                      "graphblas_tpu/sparse/pallas_window.py:101"),
        "tropical_mm": ("graphblas_tpu_torch/csrc/tropical.cu",
                        "graphblas_tpu/sparse/pallas_tropical.py:116"),
        "bsr_masked_mm": ("graphblas_tpu_torch/csrc/bsr.cu",
                          "graphblas_tpu/sparse/pallas_bsr.py:95"),
        "row_gather": ("graphblas_tpu_torch/csrc/probes.cu",
                       "tools/gather_probe.py:68"),
        "gatherdot_async": ("graphblas_tpu_torch/csrc/probes.cu",
                            "tools/gatherdot_probe.py:122"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        err, ms, pms = summary[name]
        bms, by = bounds[name]
        # no single PyTorch call computes K1, K2, the popcount pass (no
        # torch popcount, no single-call masked reduce) or K6 (torch has
        # no min-plus product)
        # each path's run was counted from zero; "launches" is the count
        # on the first path that runs the kernel (the slice that ported
        # it), "launches_by_path" every path's count
        by_path = {p: c[name] for p, c in path_launches.items() if name in c}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": repl, "launches": next(iter(by_path.values())),
                 "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "library_ms": library_ms.get(name)}
        if name in values_err_of:
            entry["values_max_abs_err"] = values_err_of[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
