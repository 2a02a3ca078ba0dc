#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card (triangle
counting, the masked valued product ``mxm``, SpMV with BFS and
PageRank, ``mxm`` into a bitmap ``Matrix``: all-pairs shortest paths
by min-plus squaring and an SpMM, the BSR tile engine with k-truss
and the gather probes, the element-wise, select, reduce and
transpose operations with the counting models built on them, and
pending tuples, extract/assign and the graph models BFS, MIS and
PageRank, the hypersparse containers, user-defined struct types and
the complex types), and check each hand-written kernel against its
plain PyTorch version.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure is an
uncaught exception and a nonzero exit):

1. build the CUDA kernels with nvcc (printing ptxas's register report);
2. each kernel against its plain version on the card, exact integer
   equality: band-ring and window-count on the Wathen nx=ny=128 plans
   (against the dense plain versions and the plain versions over the
   kernels' schedules of nonempty tiles, whose triples must equal the
   plans' ``ntriples``; timed with both bounds: the nonempty tiles' and
   the padded panels'), the popcount pass against both its plain
   versions (dense panels and compacted B rows) on random panels (W =
   1, 8, 37, 40, 1024, with and without row maps, entries past nvals,
   unsorted rowids; and sorted rowids with runs of thousands of
   entries);
3. Wathen nx=ny=16 against a dense numpy oracle, then Wathen nx=ny=128
   through ``tricount_auto`` (884,992 triangles, band-ring engine) and
   ``window_count_partials`` on its window plan (884,992 again);
4. Wathen nx=ny=384: ``tricount_auto`` (band ring) equals
   ``tricount_esc`` on the same L/U; the warm calls of phases 3 and 4
   build no schedule; after the counted path, the band ring at Wathen
   384 against both plain versions, timed in turns (phase 4b), with
   its schedule's build time and the warm ``tricount_auto``;
5. R-MAT scale 16 (edge factor 16, seed 7): nnz 1,819,622 and
   ``tricount_esc`` 15,623,664;
6. R-MAT scale 18: nnz 7,612,718 and 82,947,332 triangles;
7. the popcount pass against both plain versions at the scale-18
   plan's level 1, timed against the dense plain version, with the
   inputs' structure (nonzero-word shares, entry-weighted nonzero words
   per row, runs of one A row), two bounds (for the compacted inputs,
   and the dense-row bound of the earlier design) and the compaction's
   own time apart;
8. the gather-dot kernels (valdot, K4) against their plain versions on
   random panels (S = 1024 and 4096, float32 and int32, padded lane
   lists with nlive < E and a -1 index): int32 exactly, float32 against
   a float64 plain result within the reassociation bound
   S * 2^-24 * sum_s |a_s * b_s| per lane; the dense kernel on dense
   panels, the compacted kernel (``valdot_gatherdot_rows``) on sparse
   panels' compacted rows at S = 1024, 4096 and 16384 (wider than its
   staged row) with lanes sorted from 20 or 2,000 rows or unsorted;
9. the masked valued product on R-MAT 16 and 18 with bench.py's value
   recipe (values for L, then U, then the mask M on L's pattern, from
   ``default_rng(3)``): ``mxm(C0, M, None, "plus_times", L, U)`` with an
   empty FP32 CSR ``C0`` gives nnzC 391,597 and 1,533,157, through
   ``valdot:*`` at scale 18, and equals the ESC-only engine
   (``Descriptor(axb_method="gustavson")``): the pattern exactly, values
   within rtol=5e-5, atol=1e-4;
10. both gather-dot kernels at the main path's shapes (slab 0 of the
   R-MAT 18 plan: the compacted rows the plan cached, and the dense
   panels packed here) against their plain versions and one library
   call for the same function (``torch.sparse.sampled_addmm`` over the
   live pairs, timed only here), with two bounds (for the compacted
   inputs, and the dense bound of the earlier design), the slab's
   structure and the compaction's time, the ESC residual's ns per lane,
   and the warm R-MAT 18 ``mxm`` split into stages (it must launch the
   compacted kernel);
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
15. the window product kernel (K3) against its plain version on random
   signed int8 panels (1 and 3 block-rows, W and nJ 128 and 640) and on
   the Wathen 128 window plan, exact, timed in turns with ``torch.bmm``
   of the panels in float16 (the unmasked product, exact at these
   counts; timed only here);
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
   triples) exactly, timed there in turns with its plain version and the
   gathered-tile float16 ``torch.bmm`` + ``index_add_``; values at Wathen
   64 with bench.py's values (L, then U, from ``default_rng(3)``) within
   K * 2^-24 * sum |a * b| per entry
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
   and both probes' ``run()``;
20. the reference's ``tri_demo`` flow through the operations on the
   R-MAT 18 graph of phase 6 as CSR on the card: the degree-permuted
   symmetric ``P = A(perm, perm)`` (the permutation of
   ``tricount_prep_csr``); ``select(tril, -1)`` / ``select(triu, 1)``
   equal ``tricount_prep_csr``'s L and U entry for entry;
   ``eWiseAdd(lor)`` of L and U has P's pattern;
   ``reduce_to_vector(plus[INT64])`` of P equals the host degrees;
   ``transpose(L)`` equals U; ``mxm(C<L>, plus_times[UINT32], L, U,
   TRAN1)`` then ``reduce_to_scalar(plus[INT64])`` gives 82,947,332;
   each op's first and warm time, the engine and the kernels it
   launched;
21. k-truss through the operations on CSR: ``models.ktruss`` (``mxm(C<C>,
   plus_land[INT64], C, C)`` then ``select(SUPPORT, k - 2)``) on the
   symmetrized R-MAT 16 graph, k = 5: 726,973 edges in 10 sweeps, equal
   to ``ktruss_esc`` entry for entry (supports too);
22. the models on the card on the symmetrized R-MAT 10 graph as a
   bitmap ``Matrix``: the six ``models.tricount`` methods equal
   ``tricount_esc``; ``models.ktruss`` (k = 4) equals ``ktruss_esc``
   entry for entry; ``models.allktruss`` equals ``allktruss_esc`` in
   edges and triangles per k; ``models.kron_generate`` equals ``kron``;
23. pending tuples, extract and assign on the R-MAT 18 graph as an INT64
   CSR on the card (values U{1..99} from ``default_rng(23)``): 100,000
   ``setElement`` calls (half on existing entries, runs of 10,000
   alternating between overwrite and ``accum=plus``) and one ``wait``,
   ``removeElement``, ``resize``, ``extract`` of the induced subgraph on
   2^16 random vertices and an ``assign`` of it, doubled, back into the
   graph under the graph's own mask; each result equals a scipy rebuild
   from the host tuples exactly; each op's first and warm time;
24. ``models.bfs5m`` and ``models.bfs6`` from vertex 0 on the R-MAT 18
   CSR: the anchor levels, entry for entry equal to ``bfs_csr``;
   ``models.bfs_jit`` on the symmetrized R-MAT 14 as a bitmap
   ``Matrix``, equal to ``bfs_csr`` on its CSR;
25. ``models.mis(A, seed=42)`` on the R-MAT 18 and 16 CSR: independent
   and maximal (checked with the entries on the card), and the JAX
   package's set (its size and a digest of its members); on R-MAT 12
   the card's set, ``ipagerank`` and ``dpagerank`` (rtol 1e-12) equal
   the port's own CPU run, whose top-10 pages are the JAX package's;
   ``dpagerank`` and ``ipagerank`` on the bitmap R-MAT 14 against scipy
   oracles (float64 within rtol 1e-9; the scaled-integer arithmetic in
   uint64 exactly), ranks descending;
26. the hypersparse containers on the R-MAT 18 graph with INT64 values
   U{1..99} (``default_rng(26)``) mapped into the 2^60 id space by a
   strictly increasing map (``id_map``: n distinct ids drawn with
   ``default_rng(61)``, sorted): ``hyper_from_coo``, 10,000
   ``setElement`` calls (half on existing entries, runs of 1,000
   alternating between overwrite and ``accum=plus``) and one ``wait``,
   ``transpose``, ``select(tril)``, ``eWiseAdd`` of the strict L and U,
   ``reduce_to_vector(plus)`` into a ``SparseVec``, ``extract`` of 2^16
   random ids and an ``assign`` of the doubled subgraph under the
   graph's mask; each result equals a scipy rebuild in the compact id
   space, mapped back; each op's first and warm time;
27. the models at 2^60: BFS from id[0] on the BOOL R-MAT 18 by the
   bfs5m loop on hypersparse containers (a ``SparseVec`` frontier,
   ``vxm`` over ``lor_land`` with the complemented structural visited
   mask and REPLACE, ``eWiseAdd`` into visited): the anchor levels,
   equal to ``bfs_csr``; the masked SandiaDot count ``mxm(C<L>,
   plus_times[INT64], L, U, TRAN1)`` into a hypersparse C on the
   degree-prepped R-MAT 14, then ``reduce_to_scalar(plus)``: 2,860,691,
   equal to ``tricount_esc``; the same count on R-MAT 16 mapped into
   [0, 2^27) expands 95.2 M lanes, over the ESC lane cap, and hands off
   to the chunked CSR ESC (15,623,664); mapped into 2^60 it raises
   ``NotImplementedError``;
28. user-defined struct types: ``models.dpagerank2_csr`` (the PageRank
   semiring over {rank, invdegree}) on the R-MAT 18 BOOL CSR against a
   scipy float64 rebuild of its recurrence (the same iterations, ranks
   within rtol 1e-9), bitmap ``dpagerank2`` against ``dpagerank2_csr``
   on R-MAT 12 (within 1e-10); the SandiaDot product ``mxm(C<L>, sr,
   L, U, TRAN1)`` over the struct {n: INT64, w: FP64} (n = 1, w
   bench.py's U[0.5,1.5) values) on the degree-prepped R-MAT 16 through
   the chunked ESC: its struct ``reduce_to_scalar`` n field is
   15,623,664 and its w field equals ``plus_times[FP64]`` on the same
   values within rtol 1e-12; 10,000 struct ``setElement`` calls (runs
   of 1,000, alternately overwrites and a field-wise accum) on an
   R-MAT 18 CSR of {a: FP64, b: INT32} and a ``wait``, equal to a numpy
   rebuild;
29. the complex types: ``mxv`` with ``plus_times[FC64]`` on the R-MAT
   18 CSR (U[0.5,1.5) + i U[0.5,1.5) values) against scipy complex128
   (per row within 1e-12 of sum |a||x|); phase 9's masked product in
   FC32 on R-MAT 16 (the pattern of phase 9's FP32 product, nnzC
   391,597; values within K 2^-24 sum |ab| of scipy complex128 per
   entry); a bitmap ``plus_times[FC64]`` ``mxm`` at R-MAT 12 against
   scipy; a ``max`` row reduce over FC32 on R-MAT 18 against numpy's
   lexicographic maximum.

Launch counters are zeroed just before each path and read just after
it: before phase 3 and after phase 9 (triangle counting and ``mxm``:
the first three kernels and the compacted gather-dot), before phase 12
and after phase 13 (SpMV: K5), before and after phase 16 (the bitmap
``mxm`` path: K6 and K3), before and after phase 19 (the tile engine,
k-truss and the probes: K7, the popcount pass, both probe kernels and
the dense gather-dot, which the gather-dot probe times); every kernel of
a path must have launched there.  Phases 20 to 25 are read apart
(``ops_tri_demo``, ``ops_ktruss``, ``models``, ``ops_assign``,
``models_bfs``, ``models_mis_pagerank``), every kernel's count
printed: their engines choose which kernels run (no kernel lies on the
paths of phases 23-25).  Phases 26 and 27 are read apart too and
summed as ``hyper`` (no kernel lies on their paths either; the
hand-off's chunked CSR ESC reaches none), and phases 28 and 29 as
``udt`` and ``complex`` (every kernel gate refuses struct and complex
operands).  Their references
(``ktruss_esc``, ``tricount_esc``, ``allktruss_esc``, ``kron``,
``bfs_csr``) run outside the counted window, so a count is the path's own.  The line before the
last is the per-kernel JSON summary, with each kernel's bound (the
larger of its compulsory bytes over 3.35 TB/s and its operations over
the card's peak for their type); the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
when no CUDA device is present.
"""

import hashlib
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
# from the JAX package on the CPU (tools/graph_model_anchors.py): mis(A,
# seed=42) on the symmetrized R-MAT graphs as CSR -> (|iset|, the first
# 16 hex digits of the sha256 of its int64 members), and the dpagerank /
# ipagerank (20 iterations) top-10 pages on the bitmap R-MAT 12
MIS_ANCHORS = {16: (49_344, "850f62bd306b7c72"),
               18: (205_774, "a2027e8d4b68e5f3")}
RMAT12_PAGERANK_TOP10 = [0, 2048, 2, 128, 16, 256, 1, 4, 64, 1024]
# SandiaDot count of the degree-prepped symmetrized R-MAT 14 (ef 16,
# seed 7), tricount_esc of the JAX package on the CPU
RMAT14_NTRI = 2_860_691
# setElement calls of phase 23
PHASE23_UPDATES = 100_000
# the kernels each path must launch
MXM_PATH = ("tri_band_ring", "window_count", "bitdot_popcount",
            "valdot_gatherdot_rows")
SPMV_PATH = ("bsr_spmv",)
BITMAP_PATH = ("tropical_mm", "window_mm")
# the gather-dot probe's run() times the dense gather-dot kernel
BSR_PATH = ("bsr_masked_mm", "bitdot_popcount", "row_gather",
            "gatherdot_async", "valdot_gatherdot")
# k-truss of the symmetrized R-MAT graphs (ef 16, seed 7): scale -> (k,
# undirected edges = half the truss's entries, sweeps), ROADMAP.md anchors
KTRUSS_ANCHORS = {16: (5, 726_973, 10), 18: (10, 2_292_950, 13)}
# every kernel, in the order of the summary line
KERNELS = tuple(dict.fromkeys(MXM_PATH + SPMV_PATH + BITMAP_PATH + BSR_PATH))

# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# int8 tensor-core ops/s, and the CUDA cores' 32-bit ops/s (the float32
# rate outside the tensor cores, used for 32-bit integer ops too)
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
CUDA32_OPS = 67e12
# 32-bit instructions the CUDA cores issue per second: one per lane per
# clock, 132 SMs x 128 lanes x 1.98 GHz (an FMA counts two of CUDA32_OPS)
CUDA32_INSTR = CUDA32_OPS / 2


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    if torch.cuda.is_available():
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


def compare_timed(kernel, plain, reps: int, plain_reps: int = None):
    """Exact comparison, then device times in turns.  Returns
    (max_abs_err, kernel_ms, plain_ms)."""
    err = max_abs_err(kernel(), plain())
    if err:
        raise AssertionError(f"kernel differs from plain version by {err}")
    return (err, *turns(kernel, plain, reps, plain_reps))


def nonempty_tiles(x: torch.Tensor) -> int:
    """128x128 tiles of the (n, R, C) panels that hold a nonzero."""
    n, R, C = x.shape
    return int(torch.any(x.view(n, R // 128, 128, C // 128, 128),
                         dim=(2, 4)).sum())


def count_bounds(plan, panels):
    """(bound, padded bound) of a band-ring or window-count call, each
    (ms, by).  The bound counts the work the schedule defines: each
    nonempty 128x128 panel tile read once, the partials written once,
    the schedule read once, and 2 * 128^3 int8 operations per tile
    triple.  The padded bound, of the earlier design, reads every panel
    byte and multiplies the whole padded band or window."""
    sched = plan.schedule
    nI = plan.P.shape[0]
    tiles = sum(nonempty_tiles(x) for x in panels)
    sbytes = 4 * sum(x.numel() for x in (sched.rows, sched.cols, sched.kptr,
                                         sched.kblk))
    restated = bound(tiles * 128 * 128 + 4 * nI + sbytes,
                     2 * 128 ** 3 * sched.ntriples, INT8_OPS)
    nbytes = sum(x.numel() for x in panels) + 4 * nI
    W = plan.P.shape[2]
    if len(panels) == 2:     # band ring: s+1 k-blocks at offset s
        Wb = W // 128
        macs = sum((nI - s) * 128 ** 3 * (s + 1) for s in range(min(Wb, nI)))
    else:
        macs = nI * 128 * W * plan.M.shape[2]
    return restated, bound(nbytes, 2 * macs, INT8_OPS)


def check_scheduled(plan, ntriples: int, what: str) -> None:
    """The kernel's partials equal the plain version over its schedule,
    and the schedule holds the plan's tile triples."""
    from graphblas_tpu_torch.sparse import cuda_window as cw
    if hasattr(plan, "Ut"):
        got = cw.tricount_band_partials(plan)
        want = cw._tri_band_partials_scheduled(plan.P, plan.Ut,
                                               plan.schedule)
    else:
        got = cw.window_count_partials(plan)
        want = cw._window_count_scheduled(plan.P, plan.Q, plan.M,
                                          plan.schedule)
    err = max_abs_err(got, want)
    assert err == 0, f"{what}: kernel differs from scheduled plain by {err}"
    assert plan.schedule.ntriples == ntriples, \
        f"{what}: schedule {plan.schedule.ntriples} triples != {ntriples}"


def schedule_ms(plan) -> float:
    """Device milliseconds of building a plan's schedule anew (the
    schedule is replaced by an equal one)."""
    from graphblas_tpu_torch.sparse import window as tw
    make = tw.band_schedule if hasattr(plan, "Ut") else tw.window_schedule

    def build():
        plan.schedule = None
        make(plan)
    return cuda_ms(build, 3)


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


def random_rows_case(rng, S: int, dtype, runs):
    """Sparse random panels (rows about 0-6 % full, the first three
    empty) with their compacted rows, and a padded lane list for the
    compacted gather-dot kernel: E lanes, nlive < E, some -1 indices; A
    rows drawn from ``runs`` rows and sorted (runs of about E / runs
    lanes), or unsorted (runs of one) when ``runs`` is None."""
    from graphblas_tpu_torch.sparse import valdot as vd
    na, nb, E = 3000, 2500, 200_000
    nlive = E - E // 20 + 1

    def panel(n):
        if dtype == torch.float32:
            P = rng.random((n, S), np.float32) - 0.5
        else:
            P = rng.integers(-2**31, 2**31, (n, S),
                             dtype=np.int64).astype(np.int32)
        P[rng.random((n, S)) >= rng.random((n, 1)) * 0.06] = 0
        P[:3] = 0
        return torch.from_numpy(P).to("cuda")

    Av, Bv = panel(na), panel(nb)
    ai = rng.integers(-1, runs or na, E).astype(np.int32)
    if runs:
        ai.sort()
    bj = rng.integers(-1, nb, E).astype(np.int32)
    return (Av, Bv, vd.compact_panel(Av), vd.compact_panel(Bv),
            torch.from_numpy(ai).to("cuda"), torch.from_numpy(bj).to("cuda"),
            nlive)


def random_popcount_case(rng, W: int, maps: bool, runs: int = 0):
    """Random panels and mask entries for the popcount pass on the card:
    nzmax entries, the last 5% past nvals, maps with -1 rows, about a
    third of the words zero.  ``runs`` > 0: CSR-ordered rowids drawn
    from that many rows, so runs of one A row span several chunks of
    entries; otherwise unsorted."""
    na, nb, m, n, nzmax = 3000, 4000, 5000, 6000, 200_000
    nvals = nzmax - nzmax // 20
    dev = "cuda"

    def words(rows):
        w = rng.integers(-2**31, 2**31, (rows, W),
                         dtype=np.int64).astype(np.int32)
        w[rng.random((rows, W)) < 0.35] = 0
        return torch.from_numpy(w)

    Ap, Bp = words(na), words(nb)
    amap = bmap = None
    if maps:
        amap = torch.from_numpy(rng.integers(-1, na, m).astype(np.int32))
        bmap = torch.from_numpy(rng.integers(-1, nb, n).astype(np.int32))
    rows = rng.integers(0, runs or (m if maps else na),
                        nzmax).astype(np.int32)
    if runs:
        rows.sort()
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


def replay_pending(lin0, vals0, keys, xs, accum):
    """The host oracle of a run of setElement calls: {key: value} of the
    keys they touch, applied one by one in input order (an overwrite,
    or + the old value where ``accum``), from the sorted linear keys
    ``lin0`` / values ``vals0`` of the matrix before them."""
    state = {}
    pos = np.searchsorted(lin0, keys)
    pos = np.minimum(pos, len(lin0) - 1)
    present = lin0[pos] == keys
    for k, x, acc, p, hit in zip(keys.tolist(), xs.tolist(), accum,
                                 pos.tolist(), present.tolist()):
        if acc:
            if k in state:
                x = state[k] + x
            elif hit:
                x = int(vals0[p]) + x
        state[k] = x
    return state


def scipy_rebuild(lin, vals, nrows, ncols, rows=None, cols=None):
    """A scipy CSR of the entries at the linear keys ``lin`` (in an
    ncols-wide frame), cut to ``rows`` x ``cols`` when given."""
    import scipy.sparse as ssp
    A = ssp.csr_matrix((vals, (lin // ncols, lin % ncols)),
                       shape=(nrows, ncols))
    A.sort_indices()
    if rows is not None:
        A = A[:rows, :cols]
    return A


def same_csr(X, S, what: str) -> None:
    """The port's CsrMatrix X holds exactly scipy CSR S's entries."""
    S = S.tocsr()
    S.sort_indices()
    assert X.shape == S.shape and X.nvals == S.nnz, \
        (what, X.shape, S.shape, X.nvals, S.nnz)
    assert np.array_equal(X.indptr.cpu().numpy(), S.indptr), what
    I, J, V = X.extractTuples()
    assert np.array_equal(J, S.indices) and np.array_equal(V, S.data), what


def id_map(n: int, bound: int = 1 << 60) -> np.ndarray:
    """A strictly increasing map of n vertices into [0, bound): n distinct
    int64 drawn with ``default_rng(61)``, sorted, vertex v -> ids[v]
    (order is kept, so tril/triu and the degree prep carry over)."""
    rng = np.random.default_rng(61)
    ids = np.unique(rng.integers(0, bound, 2 * n, dtype=np.int64))
    ids = np.sort(rng.choice(ids, n, replace=False))
    assert len(ids) == n and np.all(np.diff(ids) > 0)
    return ids


def same_hyper(H, S, rid, cid, what: str) -> None:
    """The port's HyperMatrix H holds exactly scipy CSR S's entries, its
    row and column ids mapped by ``rid`` / ``cid`` (compact id v ->
    rid[v]); the present-row list is S's nonempty rows."""
    S = S.tocsr()
    S.sort_indices()
    assert H.nvals == S.nnz, (what, H.nvals, S.nnz)
    I, J, V = H.extractTuples()
    srow = np.repeat(np.arange(S.shape[0]), np.diff(S.indptr))
    assert np.array_equal(I, rid[srow]), what
    assert np.array_equal(J, cid[S.indices]), what
    assert np.array_equal(V, S.data), what
    assert H.nvec == int((np.diff(S.indptr) > 0).sum()), what
    assert np.array_equal(H.rows_present(),
                          rid[np.nonzero(np.diff(S.indptr))[0]]), what


def pagerank_oracles(I, J, n: int, iters: int = 20):
    """scipy's PageRank of the reference demos on the graph (I, J): the
    float64 ranks of ``dpagerank`` (normalized) and the uint64 ranks of
    ``ipagerank`` (its scaled-integer arithmetic, wrapping mod 2^64),
    each as a dense vector over the pages."""
    import scipy.sparse as ssp
    from graphblas_tpu_torch.models.pagerank import _crand_stream
    deg = np.bincount(I, minlength=n)
    r0 = _crand_stream(n, n)
    Cd = ssp.csr_matrix((1.0 / deg[I], (I, J)), shape=(n, n)).T.tocsr()
    r = r0.astype(np.float64) / 2147483647.0
    for _ in range(iters):
        s = (0.15 / n) * r.sum()
        r = Cd @ (0.85 * r) + s
    rd = r / r.sum()
    zs = np.uint64(1 << 30)
    ic = np.uint64(912680550)
    Ci = ssp.csr_matrix(((zs // np.maximum(deg, 1).astype(np.uint64))[I],
                         (I, J)), shape=(n, n), dtype=np.uint64).T.tocsr()
    x = r0.astype(np.uint64) // np.uint64(n)
    x[x == 0] = 1
    ia = max((zs - ic) // np.uint64(n), np.uint64(1))
    with np.errstate(over="ignore"):
        for _ in range(iters):
            s = np.uint64(x.sum(dtype=np.uint64)) * ia
            x = np.maximum((x * ic) >> np.uint64(30), np.uint64(1))
            x = Ci @ x + s
            x = np.maximum(x >> np.uint64(30), np.uint64(1))
    return rd, x


def check_ranks(ranks, want, rtol=None) -> None:
    """A model's [(page, rank)] list: every page once, descending, and
    equal to the dense ``want`` (within ``rtol`` when given)."""
    pages = np.array([p for p, _ in ranks])
    vals = np.array([v for _, v in ranks], dtype=want.dtype)
    assert np.array_equal(np.sort(pages), np.arange(len(want)))
    assert (np.diff(vals.astype(np.float64)) <= 0).all(), "not descending"
    if rtol is None:
        assert np.array_equal(vals, want[pages])
    else:
        assert np.allclose(vals, want[pages], rtol=rtol, atol=0)


def pagerank2_oracle(I, J, n: int, itermax: int = 100, tol: float = 1e-5):
    """The recurrence of ``dpagerank2_csr`` in scipy float64: the ranks
    of the present pages (normalized) and the iteration count."""
    import scipy.sparse as ssp
    A = ssp.csr_matrix((np.ones(len(I)), (I, J)), shape=(n, n))
    AT = A.T.tocsr()
    dout = np.asarray(A.sum(axis=1)).ravel()
    rp = dout > 0
    rank = np.where(rp, 1.0 / n, 0.0)
    with np.errstate(divide="ignore"):
        inv = np.where(rp, 1.0 / dout, 0.0)
    teleport = 0.15 / n
    lanes = ssp.csr_matrix((np.ones(AT.nnz), AT.indices, AT.indptr),
                           shape=(n, n))
    rdiff, iters = 1.0, 0
    while iters < itermax and rdiff > tol * tol:
        y = AT @ np.where(rp, rank * inv, 0.0)
        tp = (lanes @ rp.astype(np.float64)) > 0
        only_t = tp & ~rp
        rank_new = np.where(tp & rp, 0.85 * y + teleport,
                            np.where(only_t, y, rank))
        inv = np.where(only_t, 0.0, inv)
        new_pat = rp | tp
        d = np.where(rp & new_pat, (rank - rank_new) ** 2,
                     np.where(new_pat, rank_new, 0.0))
        rdiff = float(d.sum())
        rank, rp = rank_new, new_pat
        iters += 1
    pages = np.nonzero(rp)[0]
    return dict(zip(pages.tolist(), (rank[rp] / rank[rp].sum()).tolist())), \
        iters


def ranks_close(got, want: dict, rtol: float, what: str) -> None:
    """Every (page, rank) of ``got`` within rtol of ``want``'s."""
    g = dict(got)
    assert set(g) == set(want), what
    pages = np.fromiter(want, np.int64)
    gv = np.array([g[p] for p in pages.tolist()])
    wv = np.array([want[p] for p in pages.tolist()])
    assert np.all(np.abs(gv - wv) <= rtol * np.abs(wv)), \
        (what, float(np.max(np.abs(gv - wv) / np.abs(wv))))


def tri_semiring(gt):
    """The struct SandiaDot semiring over tri = {n: INT64, w: FP64}: n
    counts wedges (n = 1 on every entry), w carries the values'
    product; the add is the field-wise plus."""
    T = gt.Type.udt("tri", n=gt.INT64, w=gt.FP64)
    add = gt.BinaryOp("TRI_ADD", lambda a, b: {"n": a["n"] + b["n"],
                                               "w": a["w"] + b["w"]},
                      T, T, T)
    mult = gt.BinaryOp("TRI_MUL", lambda a, b: {"n": a["n"] * b["n"],
                                                "w": a["w"] * b["w"]},
                       T, T, T)
    mon = gt.monoid_new(add, {"n": 0, "w": 0.0})
    return T, gt.semiring_new(mon, mult), mon


def struct_csr(gt, X, T, w, dev):
    """X's pattern as a CsrMatrix of the struct type T with n = 1 and
    w = ``w`` (host float64, X's entry order)."""
    hp = X._options["host_pattern"]
    I, J = hp[0][:X.nvals], hp[1][:X.nvals]
    return gt.CsrMatrix.from_coo(
        I, J, {"n": np.ones(len(I), np.int64), "w": w}, X.nrows, X.ncols,
        type=T, sum_duplicates=False, device=dev)


def phase28_udt(gt, L16, U16, A18, A12, dev, tag, ntri16=None):
    """Phase 28, user-defined types (the counted path ``udt``; the
    references run before it): dpagerank2_csr on the R-MAT 18 BOOL CSR
    against a scipy float64 rebuild of the recurrence, dpagerank2 on the
    bitmap R-MAT 12 against dpagerank2_csr, the struct SandiaDot product
    on R-MAT 16 (its n field sums to the count, its w field equals
    ``plus_times[FP64]`` on the same values), and 10,000 struct
    setElement calls on R-MAT 18 against a numpy rebuild.  Returns the
    path's launch counts and the ops' (first, warm) seconds."""
    from graphblas_tpu_torch import _build
    times = {}
    # the references, outside the counted window
    I18, J18, _ = A18.extractTuples()
    n18 = A18.nrows
    (want18, it18), ref_s = timed(lambda: pagerank2_oracle(I18, J18, n18))
    I12, J12, _ = A12.extractTuples()
    A12b = gt.Matrix.from_coo(I12, J12, np.ones(len(I12), bool), A12.nrows,
                              A12.ncols, type=gt.BOOL, device=dev)
    T, sr, mon = tri_semiring(gt)
    rng = np.random.default_rng(3)
    wL = rng.random(L16.nvals).astype(np.float32).astype(np.float64) + 0.5
    wU = rng.random(U16.nvals).astype(np.float32).astype(np.float64) + 0.5
    Ls, Us = struct_csr(gt, L16, T, wL, dev), struct_csr(gt, U16, T, wU,
                                                         dev)

    def fp64(X, w):
        hp = X._options["host_pattern"]
        return gt.CsrMatrix.from_coo(hp[0][:X.nvals], hp[1][:X.nvals], w,
                                     X.nrows, X.ncols, type=gt.FP64,
                                     sum_duplicates=False, device=dev)
    Lw, Uw = fp64(L16, wL), fp64(U16, wU)
    n16 = L16.nrows
    e = np.zeros(0, np.int64)
    tran1 = gt.Descriptor(tran1=True, mask_structure=True)
    Cw = gt.mxm(gt.CsrMatrix.from_coo(e, e, np.zeros(0), n16, n16,
                                      device=dev), Lw, None,
                gt.semiring.plus_times[gt.FP64], Lw, Uw, tran1)
    Iw, Jw, Xw = Cw.extractTuples()
    del Cw, Lw, Uw
    # the 10,000 struct updates: runs of 1,000, alternately overwrites
    # and field-wise accums, half on existing entries; integral values,
    # so the FP64 sums are exact in any order
    P = gt.Type.udt("ab", a=gt.FP64, b=gt.INT32)
    pacc = gt.BinaryOp("AB_ACC", lambda x, y: {"a": x["a"] + y["a"],
                                               "b": x["b"] + y["b"]},
                       P, P, P)
    rng28 = np.random.default_rng(28)
    lin18 = I18 * n18 + J18
    base = {"a": rng28.integers(1, 100, len(I18)).astype(np.float64),
            "b": rng28.integers(1, 100, len(I18)).astype(np.int32)}
    k28 = 10_000
    keys = np.where(np.arange(k28) % 2 == 0,
                    lin18[rng28.integers(0, len(lin18), k28)],
                    rng28.integers(0, n18 * n18, k28))
    xa = rng28.integers(1, 100, k28).astype(np.float64)
    xb = rng28.integers(1, 100, k28).astype(np.int32)
    accum = (np.arange(k28) // 1000) % 2 == 1
    want_a = replay_pending(lin18, base["a"], keys, xa, accum)
    want_b = replay_pending(lin18, base["b"], keys, xb, accum)
    V = gt.CsrMatrix.from_coo(I18, J18, base, n18, n18, type=P,
                              sum_duplicates=False, device=dev)

    _build.reset_launches()
    got18, pr_first = timed(lambda: gt.models.dpagerank2_csr(A18))
    times["dpagerank2_csr R-MAT 18"] = (pr_first, None)
    (got12, it12), pr12 = timed(lambda: gt.models.dpagerank2(A12b))
    (got12c, it12c), pr12c = timed(lambda: gt.models.dpagerank2_csr(A12))
    times["dpagerank2 R-MAT 12 (bitmap)"] = (pr12, None)
    times["dpagerank2_csr R-MAT 12"] = (pr12c, None)

    def count():
        C0 = gt.CsrMatrix.from_coo(e, e, {"n": e, "w": np.zeros(0)}, n16,
                                   n16, type=T, device=dev)
        return gt.mxm(C0, Ls, None, sr, Ls, Us, tran1)
    C, c_first = timed(count)
    engine = gt.last_axb_method()
    _, c_warm = timed(count)
    times["struct SandiaDot R-MAT 16"] = (c_first, c_warm)
    tot, r_s = timed(lambda: gt.reduce_to_scalar(None, mon, C))
    times["reduce_to_scalar (struct)"] = (r_s, None)

    def updates():
        X = V
        for k in range(k28):
            k_ = int(keys[k])
            X = X.setElement({"a": float(xa[k]), "b": int(xb[k])},
                             k_ // n18, k_ % n18,
                             accum=pacc if accum[k] else None)
        return X
    Vp, set_s = timed(updates)
    Vw, wait_s = timed(Vp.wait)
    times["10,000 struct setElement"] = (set_s, None)
    times["wait"] = (wait_s, None)
    sync()
    launches = {k_: _build.launches[k_] for k_ in KERNELS}
    got, it_g = got18
    assert it_g == it18, (it_g, it18)
    ranks_close(got, want18, 1e-9, "dpagerank2_csr R-MAT 18 vs scipy")
    assert it12 == it12c, (it12, it12c)
    ranks_close(got12, dict(got12c), 1e-10, "dpagerank2 bitmap vs CSR")
    nt = int(tot["n"])
    if ntri16 is not None:
        assert nt == ntri16, (nt, ntri16)
    It, Jt, Xt = C.extractTuples()
    assert np.array_equal(It, Iw) and np.array_equal(Jt, Jw), \
        "struct product pattern != plus_times[FP64]"
    assert int(Xt["n"].sum()) == nt
    np.testing.assert_allclose(Xt["w"], Xw, rtol=1e-12)
    # the struct updates against the numpy rebuild
    lin_all = np.union1d(lin18, np.fromiter(want_a, np.int64))
    ea = np.zeros(len(lin_all))
    eb = np.zeros(len(lin_all), np.int32)
    pos = np.searchsorted(lin_all, lin18)
    ea[pos], eb[pos] = base["a"], base["b"]
    ks = np.fromiter(want_a, np.int64)
    pos = np.searchsorted(lin_all, ks)
    ea[pos] = [want_a[k_] for k_ in ks.tolist()]
    eb[pos] = [want_b[k_] for k_ in ks.tolist()]
    Iv, Jv, Xv = Vw.extractTuples()
    assert np.array_equal(Iv * n18 + Jv, lin_all), "struct wait pattern"
    assert np.array_equal(Xv["a"], ea) and np.array_equal(Xv["b"], eb), \
        "struct wait values"
    for name, (first, warm) in times.items():
        print(f"{tag} phase28 {name}: first {first:.4f} s" +
              (f", warm {warm:.4f} s" if warm is not None else ""))
    print(f"{tag} phase28 dpagerank2_csr R-MAT 18: {it_g} iterations == "
          f"scipy float64 ({ref_s:.3f} s), {len(got)} ranks within rtol "
          f"1e-9; R-MAT 12 bitmap dpagerank2 == dpagerank2_csr ({it12} "
          f"iterations, within 1e-10); struct SandiaDot R-MAT {n16.bit_length() - 1} "
          f"via {engine}: n field {nt}, w field == plus_times[FP64] "
          f"(rtol 1e-12) on {C.nvals} entries; {k28} struct setElement + "
          f"wait == numpy rebuild ({Vw.nvals} entries)")
    return launches, times


def phase29_complex(gt, L16, U16, C16, A18, A12, dev, tag, nnzc16=None):
    """Phase 29, the complex types (the counted path ``complex``; the
    scipy and numpy references run after it): ``mxv`` plus_times[FC64]
    on the R-MAT 18 CSR, phase 9's masked product in FC32 on R-MAT 16
    (pattern == phase 9's FP32 product ``C16``), a bitmap
    plus_times[FC64] ``mxm`` at R-MAT 12 and a ``max`` row reduce over
    FC32 on R-MAT 18.  Returns the path's launch counts and the ops'
    (first, warm) seconds."""
    import scipy.sparse as ssp
    from graphblas_tpu_torch import _build
    times = {}

    def first_warm(name, fn):
        out, first = timed(fn)
        _, warm = timed(fn)
        times[name] = (first, warm)
        return out
    rng = np.random.default_rng(29)
    I18, J18, _ = A18.extractTuples()
    n18 = A18.nrows
    v18 = rng.uniform(0.5, 1.5, len(I18)) + 1j * rng.uniform(0.5, 1.5,
                                                             len(I18))
    x18 = rng.uniform(0.5, 1.5, n18) + 1j * rng.uniform(0.5, 1.5, n18)
    Z18 = gt.CsrMatrix.from_coo(I18, J18, v18, n18, n18, type=gt.FC64,
                                sum_duplicates=False, device=dev)
    xv = gt.Vector.from_dense(x18, gt.FC64, device=dev)
    rng3 = np.random.default_rng(3)

    def cvals(X):
        hp = X._options["host_pattern"]
        I, J = hp[0][:X.nvals], hp[1][:X.nvals]
        re = rng3.random(len(I)).astype(np.float32) + 0.5
        im = rng3.random(len(I)).astype(np.float32) + 0.5
        v = (re + 1j * im).astype(np.complex64)
        return I, J, v, gt.CsrMatrix.from_coo(
            I, J, v, X.nrows, X.ncols, type=gt.FC32, sum_duplicates=False,
            device=dev)
    n16 = L16.nrows
    Lc, Uc, Mc = (cvals(X) for X in (L16, U16, L16))
    e = np.zeros(0, np.int64)
    C0 = gt.CsrMatrix.from_coo(e, e, np.zeros(0, np.complex64), n16, n16,
                               type=gt.FC32, device=dev)
    I12, J12, _ = A12.extractTuples()
    n12 = A12.nrows
    v12 = rng.normal(size=len(I12)) + 1j * rng.normal(size=len(I12))
    B12 = gt.Matrix.from_coo(I12, J12, v12, n12, n12, type=gt.FC64,
                             device=dev)
    re = rng.integers(0, 8, len(I18)) / 4.0
    im = rng.normal(size=len(I18))
    m18 = (re + 1j * im).astype(np.complex64)
    Zm = gt.CsrMatrix.from_coo(I18, J18, m18, n18, n18, type=gt.FC32,
                               sum_duplicates=False, device=dev)

    _build.reset_launches()
    w = first_warm("mxv plus_times[FC64] R-MAT 18", lambda: gt.mxv(
        gt.Vector.new(gt.FC64, n18, device=dev), None, None,
        gt.semiring.plus_times[gt.FC64], Z18, xv))
    mxv_engine = gt.last_axb_method()
    C = first_warm("masked mxm plus_times[FC32] R-MAT 16", lambda: gt.mxm(
        C0, Mc[3], None, gt.semiring.plus_times[gt.FC32], Lc[3], Uc[3]))
    mxm_engine = gt.last_axb_method()
    D = first_warm("bitmap mxm plus_times[FC64] R-MAT 12", lambda: gt.mxm(
        gt.Matrix.new(gt.FC64, n12, n12, device=dev), None, None,
        gt.semiring.plus_times[gt.FC64], B12, B12))
    bm_engine = gt.last_axb_method()
    r = first_warm("reduce_to_vector max[FC32] R-MAT 18", lambda:
                   gt.reduce_to_vector(gt.Vector.new(gt.FC32, n18,
                                                     device=dev),
                                       None, None, gt.monoid.max[gt.FC32],
                                       Zm))
    sync()
    launches = {k_: _build.launches[k_] for k_ in KERNELS}

    # 1. mxv against scipy complex128, per row within 1e-12 of the row's
    # magnitude sum |a| |x|
    S = ssp.csr_matrix((v18, (I18, J18)), shape=(n18, n18))
    want = S @ x18
    mag = abs(S) @ np.abs(x18)
    got = w.to_dense()
    pat = w.pattern_np()
    assert np.array_equal(pat, np.diff(S.indptr) > 0), "mxv pattern"
    assert np.all(np.abs(got - want) <= 1e-12 * mag), "mxv values"
    # 2. the masked product: phase 9's pattern; values within K 2^-24
    # sum |a b| of scipy complex128
    Lh = ssp.csr_matrix((Lc[2].astype(np.complex128), (Lc[0], Lc[1])),
                        shape=(n16, n16))
    Uh = ssp.csr_matrix((Uc[2].astype(np.complex128), (Uc[0], Uc[1])),
                        shape=(n16, n16))
    It, Jt, Xt = C.extractTuples()
    Ip, Jp, _ = C16.extractTuples()
    assert C.nvals == C16.nvals, (C.nvals, C16.nvals)
    if nnzc16 is not None:
        assert C.nvals == nnzc16, (C.nvals, nnzc16)
    assert np.array_equal(It, Ip) and np.array_equal(Jt, Jp), \
        "FC32 masked product pattern != FP32's"
    # each output entry's dot product, row i of L against column j of U
    # (the masked entries only: the unmasked product is far larger)
    Lr, Ur = Lh[It], Uh.T.tocsr()[Jt]
    want_v = np.asarray(Lr.multiply(Ur).sum(axis=1)).ravel()
    mag_v = np.asarray(abs(Lr).multiply(abs(Ur)).sum(axis=1)).ravel()
    deg = np.diff(Lh.indptr)[It]
    err = np.abs(Xt.astype(np.complex128) - want_v)
    assert np.all(err <= 4 * (deg + 2) * 2.0 ** -24 * mag_v), \
        float(np.max(err / mag_v))
    # 3. the bitmap complex product against scipy
    S12 = ssp.csr_matrix((v12, (I12, J12)), shape=(n12, n12))
    W12 = (S12 @ S12).toarray()
    M12 = (abs(S12) @ abs(S12)).toarray()
    assert np.array_equal(D.pattern_np(), M12 > 0), "bitmap pattern"
    assert np.all(np.abs(D.to_dense() - W12) <= 1e-12 * M12), \
        "bitmap values"
    # 4. the lexicographic row max of numpy
    order = np.lexsort((m18.imag, m18.real, I18))
    last = np.append(I18[order][1:] != I18[order][:-1], True)
    want_r = np.zeros(n18, np.complex64)
    want_r[I18[order][last]] = m18[order][last]
    got_r = r.to_dense()
    assert np.array_equal(r.pattern_np(), np.diff(S.indptr) > 0)
    assert np.array_equal(got_r, want_r), "complex max row reduce"
    for name, (first, warm) in times.items():
        print(f"{tag} phase29 {name}: first {first:.4f} s, warm "
              f"{warm:.4f} s")
    print(f"{tag} phase29 mxv FC64 R-MAT 18 via {mxv_engine} == scipy "
          f"(1e-12 of |A||x|); masked FC32 mxm R-MAT 16 via {mxm_engine}: "
          f"nnzC {C.nvals} == FP32 pattern, within K 2^-24 sum|ab|; "
          f"bitmap FC64 mxm R-MAT 12 via {bm_engine} == scipy; max[FC32] "
          f"row reduce == numpy's lexicographic max")
    return launches, times


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    card = card_label()
    print(card, flush=True)
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import _build
    from graphblas_tpu_torch.models.bfs import vxm_operand
    from graphblas_tpu_torch.sparse import bitdot as bd
    from graphblas_tpu_torch.sparse import cuda_spmv as cs
    from graphblas_tpu_torch.sparse import cuda_window as cw
    from graphblas_tpu_torch.sparse import esc as esc_mod
    from graphblas_tpu_torch.sparse import valdot as vd
    from graphblas_tpu_torch.sparse import window as tw
    tag = f"[{card}]"
    summary = {}
    extra_of = {}

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
    band128 = compare_timed(
        lambda: gt.tricount_band_partials(band),
        lambda: cw._tri_band_partials_plain(band.P, band.Ut), 20)
    band128_bounds = count_bounds(band, (band.P, band.Ut))
    check_scheduled(band, band.ntriples, "Wathen 128 band")
    summary["window_count"] = compare_timed(
        lambda: gt.window_count_partials(win),
        lambda: cw._window_count_plain(win.P, win.Q, win.M), 5)
    bounds = {}
    bounds["window_count"], win_padded = count_bounds(
        win, (win.P, win.Q, win.M))
    check_scheduled(win, win.ntriples, "Wathen 128 window")
    extra_of["window_count"] = {
        "padded_bound_ms": win_padded[0], "padded_bound_by": win_padded[1],
        "schedule_outputs": win.schedule.nout,
        "schedule_triples": win.schedule.ntriples,
        "schedule_ms": schedule_ms(win)}
    band128_sched_ms = schedule_ms(band)
    band128_sched = (band.schedule.nout, band.schedule.ntriples)
    rng = np.random.default_rng(0)
    popcount_cases = [(W, maps, 0) for W in (1, 8, 37, 40, 1024)
                      for maps in (False, True)]
    popcount_cases += [(1024, True, 50), (37, False, 20)]
    for W, maps, runs in popcount_cases:
        args = random_popcount_case(rng, W, maps, runs)
        got = gt.bitdot_popcount(*args)
        want = bd._bitdot_popcount_plain(*args)
        err = max(max_abs_err(got, want), max_abs_err(
            got, bd._bitdot_popcount_compact_plain(
                args[0], bd.compact_rows(args[1]), *args[2:])))
        if err:
            raise AssertionError(f"popcount W={W} maps={maps} runs={runs}: "
                                 f"{err}")
        past = got[args[-1]:]
        assert int(past.abs().sum()) == 0, "entries past nvals not 0"
    sync()
    for name, (err, ms, pms), plan, (bnd, padded) in (
            ("tri_band_ring", band128, band, band128_bounds),
            ("window_count", summary["window_count"], win,
             (bounds["window_count"], win_padded))):
        print(f"{tag} phase2 {name}: exact (max_abs_err {err}) against the "
              f"dense and the scheduled plain versions; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms (Wathen 128); schedule "
              f"{plan.schedule.nout} outputs, {plan.schedule.ntriples} "
              f"triples == plan.ntriples; bound {bnd[0]:.4f} ms ({bnd[1]}; "
              f"nonempty tiles), padded-panel bound {padded[0]:.4f} ms "
              f"({padded[1]})")
    print(f"{tag} phase2 bitdot_popcount: exact against both plain "
          f"versions on random panels W=1,8,37,40,1024 with/without maps "
          f"(unsorted rowids), and sorted rowids from 50 rows (W=1024, "
          f"maps) and 20 rows (W=37): runs of ~4,000 and ~10,000 entries")
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
    # the compacted gather-dot kernel: staged A rows (sorted lanes), and
    # searched A rows (unsorted lanes; every lane at S = 16384)
    for S in (1024, 4096, 16384):
        for dt in (torch.float32, torch.int32):
            for runs in (20, 2000, None):
                Av, Bv, Ar, Br, ai, bj, nlive = random_rows_case(rng, S, dt,
                                                                 runs)
                got = gt.valdot_gatherdot_rows(Ar, Br, ai, bj, nlive, S)
                err = check_gatherdot(got, Av, Bv, ai, bj, nlive)
                if dt == torch.int32:
                    err = max(err, max_abs_err(got, vd._gatherdot_rows_plain(
                        Ar, Br, ai, bj, nlive, S)))
                    assert err == 0, f"compacted K4 int32 differs by {err}"
                sync()
                print(f"{tag} phase8 valdot_gatherdot_rows S={S} {dt} "
                      f"{'sorted from %d rows' % runs if runs else 'unsorted'}"
                      f": {'exact' if dt == torch.int32 else 'within bound'} "
                      f"(max_abs_err {err}) on {ai.numel()} lanes, nlive "
                      f"{nlive}, {Ar.val.numel()} + {Br.val.numel()} entries")
    del Av, Bv, Ar, Br, ai, bj

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
    builds = dict(tw.schedule_builds)
    ntri2, warm = timed(lambda: gt.tricount_auto(L, U))
    assert tw.schedule_builds == builds, \
        "a warm tricount_auto built a schedule"
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
    L384, U384, n, nnz = wathen_lu(gt, 384)
    ntri, first = timed(lambda: gt.tricount_auto(L384, U384))
    engine = gt.last_axb_method()
    builds = dict(tw.schedule_builds)
    _, warm = timed(lambda: gt.tricount_auto(L384, U384))
    assert tw.schedule_builds == builds, \
        "a warm tricount_auto built a schedule"
    assert engine == "cuda:tri_band_ring", engine
    band384 = gt.build_band_plan(L384, U384)
    assert band384.schedule.ntriples == band384.ntriples, \
        (band384.schedule.ntriples, band384.ntriples)
    esc, esc_first = timed(lambda: gt.tricount_esc(L384, U384))
    esc_engine = gt.last_axb_method()
    _, esc_warm = timed(lambda: gt.tricount_esc(L384, U384))
    assert ntri == esc, f"Wathen 384: band ring {ntri} != esc {esc}"
    ntri384 = ntri
    print(f"{tag} phase4 Wathen 384: n {n}, {nnz} entries, Wb "
          f"{band384.Wb}, panels {band384.panel_bytes} B, schedule "
          f"{band384.schedule.nout} outputs, {band384.schedule.ntriples} "
          f"triples == plan.ntriples; {ntri} triangles via {engine} (first "
          f"{first:.4f} s, warm {warm:.6f} s, no schedule built warm) == "
          f"tricount_esc via {esc_engine} (first {esc_first:.4f} s, warm "
          f"{esc_warm:.6f} s)")

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
        before = _build.launches["valdot_gatherdot_rows"]
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
            assert _build.launches["valdot_gatherdot_rows"] > before, \
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
        valued[scale] = (Lv, Uv, Mv, C0, plan, C)
    sync()
    launches = {k: _build.launches[k] for k in MXM_PATH}
    print(f"main-path launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    path_launches = {"mxm": launches}

    # ---- 4b. the band ring at Wathen 384, off the counted path ----
    summary["tri_band_ring"] = compare_timed(
        lambda: gt.tricount_band_partials(band384),
        lambda: cw._tri_band_partials_plain(band384.P, band384.Ut), 20, 2)
    check_scheduled(band384, band384.ntriples, "Wathen 384 band")
    bounds["tri_band_ring"], padded = count_bounds(
        band384, (band384.P, band384.Ut))
    auto_ms = cuda_ms(lambda: gt.tricount_auto(L384, U384), 10)
    err, ms, pms = summary["tri_band_ring"]
    extra_of["tri_band_ring"] = {
        "padded_bound_ms": padded[0], "padded_bound_by": padded[1],
        "schedule_outputs": band384.schedule.nout,
        "schedule_triples": band384.schedule.ntriples,
        "schedule_ms": schedule_ms(band384),
        "warm_tricount_auto_ms": auto_ms,
        "wathen128_ms": band128[1], "wathen128_plain_ms": band128[2],
        "wathen128_max_abs_err": band128[0],
        "wathen128_bound_ms": band128_bounds[0][0],
        "wathen128_bound_by": band128_bounds[0][1],
        "wathen128_padded_bound_ms": band128_bounds[1][0],
        "wathen128_schedule_outputs": band128_sched[0],
        "wathen128_schedule_triples": band128_sched[1],
        "wathen128_schedule_ms": band128_sched_ms}
    print(f"{tag} phase4b tri_band_ring at Wathen 384 (P "
          f"{tuple(band384.P.shape)}): exact (max_abs_err {err}) against the "
          f"dense and the scheduled plain versions; kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms; schedule {band384.schedule.nout} outputs, "
          f"{band384.schedule.ntriples} triples, built in "
          f"{extra_of['tri_band_ring']['schedule_ms']:.4f} ms; bound "
          f"{bounds['tri_band_ring'][0]:.4f} ms ({bounds['tri_band_ring'][1]}"
          f"; nonempty tiles), padded-panel bound {padded[0]:.4f} ms "
          f"({padded[1]}); warm tricount_auto {auto_ms:.4f} ms (CUDA events)")
    del L384, U384, band384

    # ---- 7. popcount at the main path's shapes ----
    if not isinstance(plan18, bd.BitdotPlan):
        raise AssertionError("R-MAT 18 did not build a bitdot plan")
    lv = plan18.levels[0]
    Bc = plan18.Bcomp
    args = (plan18.Apack, plan18.Bpack, lv.amap, lv.bmap, M18.rowids,
            M18.indices, M18.nvals)
    err = max_abs_err(gt.bitdot_popcount(*args, Bcomp=Bc),
                      bd._bitdot_popcount_compact_plain(
                          plan18.Apack, Bc, *args[2:]))
    assert err == 0, "popcount differs from its compacted plain version"
    summary["bitdot_popcount"] = compare_timed(
        lambda: gt.bitdot_popcount(*args, Bcomp=Bc),
        lambda: bd._bitdot_popcount_plain(*args), 5)
    err, ms, pms = summary["bitdot_popcount"]
    comp_ms = cuda_ms(lambda: bd.compact_rows(plan18.Bpack), 5)
    # the inputs' structure: nonzero-word shares, entry-weighted nonzero
    # words of A's and B's rows, runs of one A row in entry order
    ii, jj, ok = bd._entry_rows(plan18.Apack.shape[0],
                                plan18.Bpack.shape[0], lv.amap, lv.bmap,
                                M18.rowids, M18.indices, M18.nvals)
    ii, jj = ii[ok], jj[ok]
    nzA = (plan18.Apack != 0).sum(1)
    nzB = (Bc.ptr[1:] - Bc.ptr[:-1]).long()
    share_a = float((nzA.sum() / plan18.Apack.numel()))
    share_b = float(nzB.sum() / plan18.Bpack.numel())
    wa, wb = float(nzA[ii].double().mean()), float(nzB[jj].double().mean())
    _, run_len = torch.unique_consecutive(ii, return_counts=True)
    run_mean = ii.numel() / run_len.numel()
    run_wmean = float((run_len.double() ** 2).sum() / ii.numel())
    Wp = plan18.Apack.shape[1]
    maps_bytes = 4 * sum(x.numel() for x in (lv.amap, lv.bmap)
                         if x is not None)
    # the restated bound, for the work the compacted inputs define: each
    # distinct A row once (dense), each distinct B row's compacted words
    # once (8 B each), 12 B per entry; an AND, a popcount and an add per
    # (entry, nonzero B word)
    ua, ub = torch.unique(ii), torch.unique(jj)
    nbytes = (ua.numel() * Wp * 4 + 8 * int(nzB[ub].sum())
              + M18.nzmax * 12 + maps_bytes)
    bounds["bitdot_popcount"] = bound(nbytes, 3 * int(nzB[jj].sum()),
                                      CUDA32_OPS)
    # the bound of the earlier dense-row design, kept for continuity:
    # both full rows per entry, 3 operations on every word
    dense_bound = bound((ua.numel() + ub.numel()) * Wp * 4 + M18.nzmax * 12
                        + maps_bytes, 3 * M18.nvals * Wp, CUDA32_OPS)
    extra_of["bitdot_popcount"] = {
        "dense_row_bound_ms": dense_bound[0],
        "dense_row_bound_by": dense_bound[1], "compaction_ms": comp_ms}
    print(f"{tag} phase7 bitdot_popcount at R-MAT 18 level 1 (Apack "
          f"{tuple(plan18.Apack.shape)}, Bpack {tuple(plan18.Bpack.shape)}, "
          f"{M18.nzmax} entries, {ii.numel()} with both rows): exact "
          f"against both plain versions; kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms; bound {bounds['bitdot_popcount'][0]:.4f} ms "
          f"({bounds['bitdot_popcount'][1]}; compacted B), dense-row bound "
          f"{dense_bound[0]:.4f} ms ({dense_bound[1]}); compaction of Bpack "
          f"{comp_ms:.4f} ms apart ({Bc.word.numel()} nonzero words); "
          f"nonzero words: A {share_a:.4f}, B {share_b:.4f} of the panels, "
          f"entry-weighted A {wa:.1f}, B {wb:.1f} of {Wp} per row; runs of "
          f"one A row: {run_len.numel()}, mean {run_mean:.1f} entries "
          f"(entry-weighted {run_wmean:.1f}); distinct rows A "
          f"{ua.numel()}, B {ub.numel()}")
    del ii, jj, ok, nzA, nzB, run_len, ua, ub
    sync()

    # ---- 10. the gather-dot kernels at the main path's shapes ----
    Lv, Uv, Mv, C0, plan, _ = valued[18]
    ncached = sum(v.rows is not None for v in plan.levels)
    assert ncached == len(plan.levels), "the plan did not cache every slab"
    lv = plan.levels[0]
    S, nlive = lv.S, lv.nlive
    Ar, Br = lv.rows
    # the dense panels of the slab, packed here for the dense kernel and
    # the library call (the main path builds none)
    Av, Bv, _, _ = vd._pack_level(lv, bits=False)
    args = (Av, Bv, lv.live_ai, lv.live_bj, nlive)
    rargs = (Ar, Br, lv.live_ai, lv.live_bj, nlive, S)
    err = check_gatherdot(gt.valdot_gatherdot(*args), *args)
    rerr = check_gatherdot(gt.valdot_gatherdot_rows(*rargs), *args)
    # the library call for the same function: cuSPARSE's sampled dense
    # product (SDDMM) over the live (ai, bj) pairs as a CSR pattern.  The
    # live lanes are mask entries in CSR order and the row maps are
    # monotone and one-to-one, so the pairs are row-sorted and unique and
    # the CSR values come out in lane order.
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
    # the compacted kernel in turns with its plain version, and the dense
    # kernel again inside the same turns
    rms, rpms, dms = turns(lambda: gt.valdot_gatherdot_rows(*rargs),
                           lambda: vd._gatherdot_rows_plain(*rargs), 10, 2,
                           lambda: gt.valdot_gatherdot(*args))
    comp_ms = cuda_ms(lambda: vd.compact_level(lv._replace(rows=None)), 5)
    comp_all_ms = cuda_ms(lambda: [vd.compact_level(v._replace(rows=None))
                                   for v in plan.levels], 2)
    summary["valdot_gatherdot"] = (err, ms, pms)
    summary["valdot_gatherdot_rows"] = (rerr, rms, rpms)
    library_ms = {"valdot_gatherdot": lms, "valdot_gatherdot_rows": lms}
    dense_bound = bound(
        (distinct(ai) + distinct(bj)) * S * 4 + nlive * 12, 2 * S * nlive,
        CUDA32_OPS)
    bounds["valdot_gatherdot"] = dense_bound
    # the restated bound, for the work the compacted inputs define: each
    # distinct row's (slot, value) pairs once (8 B each), 12 B per lane;
    # a multiply and an add per (lane, B entry)
    lenA = (Ar.ptr[1:] - Ar.ptr[:-1]).long()
    lenB = (Br.ptr[1:] - Br.ptr[:-1]).long()
    ua, ub = torch.unique(ai), torch.unique(bj)
    pairs = int(lenB[bj].sum())
    bounds["valdot_gatherdot_rows"] = bound(
        8 * int(lenA[ua].sum() + lenB[ub].sum()) + nlive * 12, 2 * pairs,
        CUDA32_OPS)
    _, run_len = torch.unique_consecutive(ai, return_counts=True)
    extra_of["valdot_gatherdot_rows"] = {
        "dense_bound_ms": dense_bound[0], "dense_bound_by": dense_bound[1],
        "dense_kernel_ms": dms, "compaction_ms": comp_ms,
        "compaction_all_slabs_ms": comp_all_ms}
    model_ns = (2 * vd._ISSUE_NS + S * 8 / vd._STREAM_BW) * 1e9
    resid = (lambda: esc_mod.csr_spgemm(sr, plan.A_light, Uv, mask=Mv))
    resid_ms = cuda_ms(resid, 3)
    rb = bounds["valdot_gatherdot_rows"]
    print(f"{tag} phase10 gather-dot at R-MAT 18 slab 0 (S {S}, panel rows "
          f"{lv.na} x {lv.nb}, nlive {nlive}): compacted kernel "
          f"(valdot_gatherdot_rows) max_abs_err {rerr}, dense kernel "
          f"max_abs_err {err}, sampled_addmm max_abs_err {lib_err} (all "
          f"within bound); compacted {rms:.4f} ms (plain {rpms:.4f}) with "
          f"the dense kernel {dms:.4f} in its turns; dense {ms:.4f} ms "
          f"(plain {pms:.4f}), sampled_addmm {lms:.4f} ms in theirs; bound "
          f"for the compacted inputs {rb[0]:.6f} ms ({rb[1]}), dense bound "
          f"{dense_bound[0]:.4f} ms ({dense_bound[1]}); compaction "
          f"{comp_ms:.4f} ms for the slab, {comp_all_ms:.4f} ms for all "
          f"{len(plan.levels)} slabs (once per plan); {rms * 1e6 / nlive:.3f}"
          f" ns per live lane (cost model {model_ns:.1f}); ESC residual "
          f"{resid_ms:.4f} ms for {plan.light_lanes} lanes, "
          f"{resid_ms * 1e6 / max(plan.light_lanes, 1):.3f} ns per lane "
          f"(cost model {vd._ESC_NS * 1e9:.1f})")
    wa = float(lenA[ai].double().mean())
    wb = float(lenB[bj].double().mean())
    print(f"{tag} phase10 slab 0 inputs: {Ar.val.numel()} + "
          f"{Br.val.numel()} panel entries ({Ar.val.numel() / (lv.na * S):.4f}"
          f" / {Br.val.numel() / (lv.nb * S):.4f} of the panels); distinct "
          f"rows A {ua.numel()}, B {ub.numel()}; sum over lanes of nnz(B "
          f"row) {pairs}; lane-weighted nnz A {wa:.1f}, B {wb:.1f}; runs "
          f"of one A row {run_len.numel()}, mean "
          f"{nlive / run_len.numel():.1f} lanes")
    del Av, Bv, BvT, pattern, lib_out, ai, bj, key, crow, lenA, lenB, ua, ub
    # where the warm R-MAT 18 mxm goes: every slab's compacted gather-dot
    # (no per-call packing: the plan caches every slab's rows), the dense
    # design it replaced (with its per-call pack, and the pack alone), the
    # slab pass with its merges, the whole engine (+ the residual and the
    # combine), and the whole mxm (+ the accum/mask epilogue)
    live = [v for v in plan.levels if v.nlive]
    k4_all = cuda_ms(lambda: [gt.valdot_gatherdot_rows(
        *v.rows, v.live_ai, v.live_bj, v.nlive, v.S) for v in live], 3)
    k4_dense_all = cuda_ms(lambda: [gt.valdot_gatherdot(
        *vd._pack_level(v, bits=False)[:2], v.live_ai, v.live_bj, v.nlive)
        for v in live], 3)
    pack_all = cuda_ms(lambda: [vd._pack_level(v, bits=False)
                                for v in live], 3)
    heavy = cuda_ms(lambda: vd._valdot_heavy(plan, sr, Mv), 3)
    engine = cuda_ms(lambda: vd.valdot_masked_spgemm(sr, Lv, Uv, Mv), 3)
    before = _build.launches["valdot_gatherdot_rows"]
    whole = cuda_ms(lambda: gt.mxm(C0, Mv, None, "plus_times", Lv, Uv), 3)
    # warm-up and three timed calls, one launch per live slab each
    assert (_build.launches["valdot_gatherdot_rows"] - before
            == 4 * len(live)), "the warm mxm did not launch the compacted K4"
    print(f"{tag} phase10 R-MAT 18 warm mxm breakdown (CUDA events, ms): "
          f"compacted gather-dot over {len(live)} slabs {k4_all:.4f} "
          f"(kernel only; per-call packing none: {ncached} of "
          f"{len(plan.levels)} slabs' rows cached, {plan.panel_bytes} B); "
          f"the dense kernel with its per-call pack {k4_dense_all:.4f} (the "
          f"pack alone {pack_all:.4f}); slab pass with merges {heavy:.4f}; "
          f"residual ESC {resid_ms:.4f}; combine "
          f"{engine - heavy - resid_ms:.4f}; valdot engine {engine:.4f}; "
          f"epilogue {whole - engine:.4f}; mxm {whole:.4f}")
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
    # the issue limit: each of the N^3 terms is one FADD and one FMNMX, no
    # fused add-min exists for float32; the earlier bound priced both at
    # the FMA's flop rate, half an instruction each
    bounds["tropical_mm"] = bound(3 * N * N * 4, 2 * N ** 3, CUDA32_INSTR)
    flop_bound = bound(3 * N * N * 4, 2 * N ** 3, CUDA32_OPS)
    extra_of["tropical_mm"] = {"flop_rate_bound_ms": flop_bound[0]}
    print(f"{tag} phase14 tropical_mm min-plus at {N}^3: equal to plain; "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain (once) {pms:.4f} ms, bound "
          f"{bounds['tropical_mm'][0]:.4f} ms "
          f"({bounds['tropical_mm'][1]}; an FADD and an FMNMX a term at "
          f"one instruction a lane a clock; {flop_bound[0]:.4f} ms at the "
          f"FMA flop rate), {2 * N ** 3 / (min(k1, k2) * 1e-3) / 1e12:.3f} "
          f"T ops/s")
    del a, b, want

    # ---- 15. the window product kernel (K3) against its plain version ----
    from types import SimpleNamespace
    rng = np.random.default_rng(15)

    def panel(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape,
                                             dtype=np.int8)).to("cuda")

    for nI in (1, 3):
        for W in (128, 640):
            for nJ in (128, 640):
                pl = SimpleNamespace(P=panel(nI, 128, W), Q=panel(nI, W, nJ),
                                     M=panel(nI, 128, nJ))
                err = max_abs_err(gt.window_masked_mm_pallas(pl),
                                  cw._window_mm_plain(pl.P, pl.Q, pl.M))
                assert err == 0, f"K3 signed nI={nI} W={W} nJ={nJ}: {err}"
    sync()
    print(f"{tag} phase15 window_mm: exact on random signed int8 panels, "
          f"nI in (1, 3), W and nJ in (128, 640)")
    del pl
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

    def k7_timed(nx, reps):
        """K7's counting form at the Wathen nx schedule (M = A = L, B =
        Uᵀ from COO tiles): exact against its plain version, equal to the
        gathered float16 bmm + index_add_ (unmasked, the library
        formulation; timed only here) once masked, and timed in turns with
        both.  Returns (the counts, tiles of L, the numpy schedule,
        kernel_ms, plain_ms, library_ms)."""
        Lt, Bt, _, _, _ = wathen_tiles(gt, nx)
        args, sched = k7_schedule(tcb, Lt, Lt, Bt)
        nout = len(sched[3])
        counts = torch.from_numpy(np.diff(sched[0]).astype(np.int64)).cuda()
        oid = torch.repeat_interleave(torch.arange(nout, device="cuda"),
                                      counts)
        ta_l, tb_l = args[1].long(), args[2].long()

        def k7():
            return tcb.bsr_tiles_mm(*args, Lt.tiles, Bt.tiles, Lt.tiles,
                                    torch.int32)

        def k7_library():
            return bsr_mod._product_counts(Lt.tiles, Bt.tiles, ta_l, tb_l,
                                           oid, nout)

        def k7_plain():
            return tcb._bsr_mm_plain(*args, Lt.tiles, Bt.tiles, Lt.tiles,
                                     torch.int32)

        got = k7()
        err = max_abs_err(got, k7_plain())
        assert err == 0, f"K7 counting differs from its plain version by {err}"
        masked = k7_library() * (Lt.tiles[args[3].long()] != 0)
        assert torch.equal(masked, got), "float16 bmm (masked) != K7"
        del masked
        ms, pms, lms = turns(k7, k7_plain, reps, 2, k7_library)
        return got, Lt, Bt, args, sched, ms, pms, lms

    got, Lt, _, _, sched, ms, pms, lms = k7_timed(128, 50)
    assert int(got.sum(dtype=torch.int64)) == WATHEN_128_NTRI
    b128 = k7_bound(sched, 1, 4, a_is_m=True)
    sync()
    print(f"{tag} phase17 bsr_masked_mm counting at Wathen 128 ({Lt.ntiles} "
          f"L tiles, {len(sched[1])} triples, kmax {sched[4]}): exact, "
          f"sum {WATHEN_128_NTRI}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"float16 bmm + index_add_ {lms:.4f} ms, bound {b128[0]:.4f} ms "
          f"({b128[1]})")
    del got, Lt
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
    got, Lt, Bt, args, sched, ms, pms, lms = k7_timed(384, 20)
    nout = len(sched[3])
    assert int(got.sum(dtype=torch.int64)) == ntri384
    summary["bsr_masked_mm"] = (0, ms, pms)   # exact at both schedules
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
    del Lt, Bt, Af, Bf, args, got
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

    # ---- the operations and the counting models: 20-22, counted ----
    e64 = np.zeros(0, np.int64)

    def empty_csr(t, n):
        return gt.CsrMatrix.from_coo(e64, e64, np.zeros(0, t.dtype), n, n,
                                     type=t, device="cuda")

    def same_entries(X, Y, what):
        """X and Y hold the same entries (rows, columns, values)."""
        assert X.shape == Y.shape and X.nvals == Y.nvals, \
            (what, X.shape, Y.shape, X.nvals, Y.nvals)
        for a, b in zip(X.extractTuples(), Y.extractTuples()):
            assert np.array_equal(a, b), f"{what}: entries differ"

    def path_counts():
        """every kernel's count since the last reset_launches()"""
        return {k: _build.launches[k] for k in KERNELS}

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # 20. the reference's tri_demo flow through the operations, R-MAT 18
    t_phase = time.perf_counter()
    L18, U18, _, A18s = graphs[18]
    n = A18s.nrows
    hp = A18s._options["host_pattern"]
    I18 = hp[0][:A18s.nvals].astype(np.int64)
    J18 = hp[1][:A18s.nvals].astype(np.int64)
    t0 = time.perf_counter()
    deg = np.bincount(I18, minlength=n)
    perm = np.argsort(deg, kind="stable")     # sparse/tri.py:363-367
    rank = np.empty(n, np.int64)
    rank[perm] = np.arange(n)
    P = gt.CsrMatrix.from_coo(rank[I18], rank[J18], np.ones(len(I18), bool),
                              n, n, type=gt.BOOL, sum_duplicates=False,
                              device="cuda")
    p_secs = time.perf_counter() - t0
    op_times = {}

    def first_warm(name, fn):
        before = dict(_build.launches)
        out, first = timed(fn)
        mid = dict(_build.launches)
        _, warm = timed(fn)
        op_times[name] = (first, warm, {k: mid[k] - before[k]
                                        for k in KERNELS if mid[k] > before[k]})
        return out
    L = first_warm("select tril", lambda: gt.select(
        empty_csr(gt.BOOL, n), None, None, gt.selectop.tril, P, -1))
    U = first_warm("select triu", lambda: gt.select(
        empty_csr(gt.BOOL, n), None, None, gt.selectop.triu, P, 1))
    same_entries(L, L18, "select tril vs tricount_prep_csr's L")
    same_entries(U, U18, "select triu vs tricount_prep_csr's U")
    S = first_warm("eWiseAdd lor", lambda: gt.eWiseAdd(
        empty_csr(gt.BOOL, n), None, None, gt.binary.lor[gt.BOOL], L, U))
    assert S.nvals == P.nvals and torch.equal(
        S.rowids[:S.nvals], P.rowids[:P.nvals]) and torch.equal(
        S.indices[:S.nvals], P.indices[:P.nvals]), "L ∪ U is not P"
    dvec = first_warm("reduce_to_vector plus", lambda: gt.reduce_to_vector(
        gt.Vector.new(gt.INT64, n, device="cuda"), None, None,
        gt.monoid.plus[gt.INT64], P))
    assert np.array_equal(dvec.to_dense(), np.bincount(rank[I18],
                                                       minlength=n)), \
        "the degree reduce differs from the host degrees"
    Lt = first_warm("transpose", lambda: gt.transpose(
        empty_csr(gt.BOOL, n), None, None, L))
    same_entries(Lt, U, "transpose(L) vs U")
    C = first_warm("mxm plus_times UINT32", lambda: gt.mxm(
        empty_csr(gt.UINT32, n), L, None, gt.semiring.plus_times[gt.UINT32],
        L, U, gt.TRAN1))
    mxm_engine = gt.last_axb_method()
    ntri = first_warm("reduce_to_scalar plus", lambda: gt.reduce_to_scalar(
        None, gt.monoid.plus[gt.INT64], C))
    assert ntri == RMAT_ANCHORS[18][1], f"R-MAT 18 through the ops: {ntri}"
    assert C.type.name == "UINT32" and C.nvals > 0
    sync()
    ops_launches = path_counts()
    for name, (first, warm, kl) in op_times.items():
        print(f"{tag} phase20 {name}: first {first:.4f} s, warm {warm:.4f} s"
              f", kernels launched {json.dumps(kl)}")
    print(f"{tag} phase20 R-MAT 18 tri_demo flow (n {n}, P {P.nvals} entries "
          f"built in {p_secs:.3f} s): L, U == tricount_prep_csr's ({L.nvals}"
          f" entries each), L ∪ U == P, degrees == host, transpose(L) == U; "
          f"mxm<L> plus_times[UINT32] (L, U') via {mxm_engine}: nnzC "
          f"{C.nvals}, sum {ntri} == {RMAT_ANCHORS[18][1]}; phase "
          f"{time.perf_counter() - t_phase:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    print(f"ops-tri-demo-path launches: {json.dumps(ops_launches)}")
    path_launches["ops_tri_demo"] = ops_launches
    del P, L, U, S, Lt, C, dvec, L18, U18, I18, J18, rank, perm, deg

    # 21. k-truss through the operations on CSR (models/ktruss.py's loop):
    # R-MAT 16, k = 5; only models.ktruss runs inside the counted window
    t_phase = time.perf_counter()
    k, want_e, want_s = KTRUSS_ANCHORS[16]
    A16s = graphs[16][3]
    _build.reset_launches()
    (C21, steps), secs = timed(lambda: gt.models.ktruss(A16s, k))
    engine21 = gt.last_axb_method()
    sync()
    ktruss_launches = path_counts()
    assert isinstance(C21, gt.CsrMatrix) and \
        (C21.nvals // 2, steps) == (want_e, want_s), (C21.nvals, steps)
    truss, sup, esc_steps = gt.ktruss_esc(A16s, k)
    assert steps == esc_steps, (steps, esc_steps)
    I21, J21, X21 = C21.extractTuples()
    It, Jt, _ = truss.extractTuples()
    assert np.array_equal(I21, It) and np.array_equal(J21, Jt), \
        "the k-truss through the ops differs from ktruss_esc's"
    assert np.array_equal(X21, sup[:truss.nvals].cpu().numpy()), \
        "the supports differ from ktruss_esc's"
    print(f"{tag} phase21 models.ktruss on CSR R-MAT 16 k={k}: "
          f"{C21.nvals // 2} edges in {steps} sweeps == ktruss_esc entry for "
          f"entry (supports too); {secs:.3f} s ({secs / steps:.3f} s a "
          f"sweep, the last product via {engine21}); phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    print(f"ops-ktruss-path launches: {json.dumps(ktruss_launches)}")
    path_launches["ops_ktruss"] = ktruss_launches
    del C21, truss, sup

    # 22. the models on the card: symmetrized R-MAT 10 as a bitmap Matrix;
    # the references run first, outside the counted window
    t_phase = time.perf_counter()
    n10 = 1 << 10
    I10, J10 = gt.symmetrize_pattern(*gt.rmat_edges(10, 16, seed=7), n10)
    X10 = np.ones(len(I10), bool)
    A10 = gt.Matrix.from_coo(I10, J10, X10, n10, n10, type=gt.BOOL,
                             device="cuda")
    A10c = gt.CsrMatrix.from_coo(I10, J10, X10, n10, n10, type=gt.BOOL,
                                 sum_duplicates=False, device="cuda")
    A10f = gt.Matrix.from_coo(I10, J10, np.ones(len(I10)), n10, n10,
                              type=gt.FP64, device="cuda")
    rng6 = np.random.default_rng(6)
    Bd = (rng6.random((3, 3)) < 0.5) * rng6.random((3, 3))
    B3 = gt.Matrix.from_dense(Bd, gt.FP64, pattern=Bd != 0, device="cuda")
    want10 = gt.tricount_esc(*gt.tricount_prep_csr(A10c))
    t10, s10, est10 = gt.ktruss_esc(A10c, 4)
    allk_esc = gt.allktruss_esc(A10c)
    K2 = gt.kron(gt.Matrix.new(gt.FP64, 3 * n10, 3 * n10, device="cuda"),
                 None, None, gt.binary.times[gt.FP64], A10f, B3)
    sync()
    _build.reset_launches()
    L10, U10 = gt.models.tricount_prep(A10)
    E10 = gt.models.edge_incidence(A10)
    method_s, got10 = {}, {}
    for m, name in enumerate(gt.models.METHODS):
        got10[name], method_s[name] = timed(lambda: gt.models.tricount(
            m, A=A10, E=E10, L=L10, U=U10))
    C10, st10 = gt.models.ktruss(A10, 4)
    allk = gt.models.allktruss(A10)
    K1 = gt.models.kron_generate(A10f, B3)
    sync()
    models_launches = path_counts()
    for name, got in got10.items():
        assert got == want10, f"tricount {name}: {got} != {want10}"
    I, J, X = C10.extractTuples()
    It, Jt, _ = t10.extractTuples()
    assert st10 == est10 and np.array_equal(I, It) and \
        np.array_equal(J, Jt) and np.array_equal(
            X, s10[:t10.nvals].cpu().numpy()), "models.ktruss != ktruss_esc"
    assert {k: (v["nedges"], v["nt"]) for k, v in allk.items()} == \
        {k: (v["nedges"], v["nt"]) for k, v in allk_esc.items()}, \
        (allk, allk_esc)
    assert torch.equal(K1.pattern, K2.pattern) and torch.equal(
        K1.values, K2.values), "kron_generate != kron"
    print(f"{tag} phase22 models on R-MAT 10 (n {n10}, {len(I10)} entries, "
          f"bitmap): all six tricount methods == tricount_esc ({want10}); "
          f"seconds " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  method_s.items()) +
          f"; ktruss k=4 {C10.nvals() // 2} edges in {st10} sweeps == "
          f"ktruss_esc; allktruss to k={max(allk)} == allktruss_esc (edges, "
          f"triangles); kron_generate == kron ({K1.nvals()} entries); phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    print(f"models-path launches: {json.dumps(models_launches)}")
    path_launches["models"] = models_launches

    # ---- pending tuples, extract/assign and the graph models: 23-25 ----
    # (no kernel lies on these paths; every count is read and printed)
    # 23. the containers at R-MAT 18: an INT64-valued copy of the graph
    # on the card takes 100,000 setElement calls and one wait, then
    # removeElement, resize, the induced subgraph by extract and an
    # assign of it back under the graph's mask; each result against a
    # scipy rebuild from the host tuples (exact)
    t_phase = time.perf_counter()
    A18s = graphs[18][3]
    n = A18s.nrows
    hp = A18s._options["host_pattern"]
    I18 = hp[0][:A18s.nvals].astype(np.int64)
    J18 = hp[1][:A18s.nvals].astype(np.int64)
    lin18 = I18 * n + J18                       # sorted: CSR order
    rng23 = np.random.default_rng(23)
    X18 = rng23.integers(1, 100, len(I18)).astype(np.int64)
    V = gt.CsrMatrix.from_coo(I18, J18, X18, n, n, type=gt.INT64,
                              sum_duplicates=False, device="cuda")
    k = PHASE23_UPDATES
    old = rng23.integers(0, len(I18), k // 2)
    ui = np.concatenate([I18[old], rng23.integers(0, n, k - k // 2)])
    uj = np.concatenate([J18[old], rng23.integers(0, n, k - k // 2)])
    ux = rng23.integers(-50, 50, k)
    order = rng23.permutation(k)
    ui, uj, ux = ui[order], uj[order], ux[order]
    # runs of 10,000 calls alternate between overwrite and accum=plus
    use_acc = (np.arange(k) // 10_000) % 2 == 1
    plus64 = gt.binary.plus[gt.INT64]
    _build.reset_launches()
    op_times = {}

    def set_all():
        B = V
        for e in range(k):
            B = B.setElement(np.int64(ux[e]), int(ui[e]), int(uj[e]),
                             accum=plus64 if use_acc[e] else None)
        return B

    def first_warm23(name, fn):
        out, first = timed(fn)
        _, warm = timed(fn)
        op_times[name] = (first, warm)
        return out
    B = first_warm23(f"setElement x{k}", set_all)
    assert len(B._pending) == k and not V._pending
    W = first_warm23("wait", B.wait)
    state = replay_pending(lin18, X18, ui * n + uj, ux, use_acc)
    skeys = np.fromiter(state, np.int64, len(state))
    svals = np.fromiter(state.values(), np.int64, len(state))
    keep = ~np.isin(lin18, skeys)
    lin_w = np.concatenate([lin18[keep], skeys])
    val_w = np.concatenate([X18[keep], svals])
    Wsp = scipy_rebuild(lin_w, val_w, n, n)
    same_csr(W, Wsp, "setElement + wait vs the scipy rebuild")
    gone = int(lin18[12345])
    R = first_warm23("removeElement", lambda: W.removeElement(
        gone // n, gone % n))
    kr = lin_w != gone
    same_csr(R, scipy_rebuild(lin_w[kr], val_w[kr], n, n),
             "removeElement vs scipy")
    m_r, n_r = n - 1000, n - 2000
    Z = first_warm23("resize", lambda: R.resize(m_r, n_r))
    same_csr(Z, scipy_rebuild(lin_w[kr], val_w[kr], n, n, m_r, n_r),
             "resize vs scipy")
    # the induced subgraph on 2^16 random vertices (in random order)
    S = rng23.choice(n, 1 << 16, replace=False)
    m = len(S)
    G = first_warm23("extract", lambda: gt.extract(
        empty_csr(gt.INT64, m), None, None, W, S, S))
    same_csr(G, Wsp[S][:, S], "extract of the induced subgraph vs scipy")
    D = gt.apply(G, None, plus64, gt.unary.identity[gt.INT64], G)  # 2 G
    C23 = first_warm23("assign", lambda: gt.assign(W, A18s, None, D, S, S))
    # the oracle: Z = W with Z(S, S) = D; C<M> = Z under the mask M of
    # the graph's own pattern, W kept outside it
    Dh = D.extractTuples()
    dlin = S[Dh[0]] * n + S[Dh[1]]
    ins = np.zeros(n, bool)
    ins[S] = True
    in_reg = ins[lin_w // n] & ins[lin_w % n]
    zl = np.concatenate([lin_w[~in_reg], dlin])
    zv = np.concatenate([val_w[~in_reg], Dh[2]])
    zm = np.isin(zl, lin18)
    wm = np.isin(lin_w, lin18)
    same_csr(C23, scipy_rebuild(np.concatenate([zl[zm], lin_w[~wm]]),
                                np.concatenate([zv[zm], val_w[~wm]]), n, n),
             "assign<M> of the doubled subgraph vs scipy")
    sync()
    assign_launches = path_counts()
    for name, (first, warm) in op_times.items():
        print(f"{tag} phase23 {name}: first {first:.4f} s, warm "
              f"{warm:.4f} s")
    print(f"{tag} phase23 R-MAT 18 INT64 (n {n}, {len(I18)} entries): "
          f"{k} setElement calls ({len(state)} keys, runs of 10,000 with "
          f"and without accum=plus) + wait -> {W.nvals} entries, "
          f"removeElement -> {R.nvals}, resize to {m_r}x{n_r} -> {Z.nvals}, "
          f"extract of {m} vertices -> {G.nvals} entries, assign<M> -> "
          f"{C23.nvals}: each == the scipy rebuild; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    print(f"ops-assign-path launches: {json.dumps(assign_launches)}")
    path_launches["ops_assign"] = assign_launches
    del V, B, W, R, Z, G, D, C23, Wsp, state, lin_w, val_w, zl, zv

    # 24. BFS through the operations: bfs5m and bfs6 on the R-MAT 18 CSR
    # (the anchor levels, entry for entry with bfs_csr), bfs_jit on the
    # bitmap R-MAT 14 (equal to bfs_csr on its CSR)
    t_phase = time.perf_counter()
    _build.reset_launches()
    want_lev = gt.bfs_csr(A18s, 0)
    # the models' one host resort of A into its by-column twin, alone
    _, resort_s = timed(lambda: vxm_operand(A18s))
    bfs_times = {}
    for name in ("bfs5m", "bfs6"):
        fn = getattr(gt.models, name)
        v, first = timed(lambda: fn(A18s, 0))
        _, warm = timed(lambda: fn(A18s, 0))
        lev = np.zeros(n, np.int64)
        vi, vx = v.extractTuples()
        lev[vi] = vx
        vals, cnts = np.unique(lev, return_counts=True)
        assert dict(zip(vals.tolist(), cnts.tolist())) == \
            RMAT18_BFS_LEVELS, (name, vals, cnts)
        assert np.array_equal(lev, want_lev), f"{name} != bfs_csr"
        assert (vx > 0).all(), f"{name} kept explicit zeros"
        bfs_times[name] = (first, warm, len(vi))
    n14 = 1 << 14
    I14, J14 = gt.symmetrize_pattern(*gt.rmat_edges(14, 16, seed=7), n14)
    t0 = time.perf_counter()
    A14 = gt.Matrix.from_coo(I14, J14, np.ones(len(I14), bool), n14, n14,
                             type=gt.BOOL, device="cuda")
    sync()
    a14_s = time.perf_counter() - t0
    A14c = gt.CsrMatrix.from_coo(I14, J14, np.ones(len(I14), bool), n14,
                                 n14, type=gt.BOOL, sum_duplicates=False,
                                 device="cuda")
    lev14, jfirst = timed(lambda: gt.models.bfs_jit(A14, 0))
    _, jwarm = timed(lambda: gt.models.bfs_jit(A14, 0))
    assert np.array_equal(lev14, gt.bfs_csr(A14c, 0)), "bfs_jit != bfs_csr"
    sync()
    bfs_launches = path_counts()
    for name, (first, warm, reached) in bfs_times.items():
        print(f"{tag} phase24 {name} on CSR R-MAT 18: {reached} reached, "
              f"levels == {RMAT18_BFS_LEVELS} == bfs_csr entry for entry; "
              f"first {first:.4f} s, warm {warm:.4f} s")
    print(f"{tag} phase24 the models' host resort of the R-MAT 18 CSR "
          f"into its by-column twin alone: {resort_s:.4f} s")
    print(f"{tag} phase24 bfs_jit on bitmap R-MAT 14 (n {n14}, "
          f"{len(I14)} entries, built in {a14_s:.3f} s): "
          f"{int((lev14 > 0).sum())} reached, == bfs_csr; first "
          f"{jfirst:.4f} s, warm {jwarm:.4f} s; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    print(f"models-bfs-path launches: {json.dumps(bfs_launches)}")
    path_launches["models_bfs"] = bfs_launches

    # 25. MIS and PageRank: mis on the R-MAT 18 / 16 CSR (independent,
    # maximal, the JAX package's set), on R-MAT 12 equal to the port's
    # CPU run; dpagerank / ipagerank on the bitmap R-MAT 14 against the
    # scipy oracles and on R-MAT 12 against the port's CPU run
    t_phase = time.perf_counter()
    _build.reset_launches()
    mis_info = {}
    for scale, Ag in ((18, A18s), (16, graphs[16][3])):
        iset, secs = timed(lambda: gt.models.mis(Ag, seed=42))
        si, sx = iset.extractTuples()
        members = si[sx]
        inset = torch.zeros(Ag.nrows, dtype=torch.bool, device="cuda")
        inset[torch.from_numpy(members).cuda()] = True
        rows = Ag.rowids[:Ag.nvals].long()
        cols = Ag.indices[:Ag.nvals].long()
        assert not bool((inset[rows] & inset[cols]).any()), \
            f"R-MAT {scale}: the set is not independent"
        covered = torch.zeros(Ag.nrows, dtype=torch.int32, device="cuda")
        covered.index_add_(0, rows, inset[cols].to(torch.int32))
        deg = Ag.row_degrees()
        assert not bool(((~inset) & (deg > 0) & (covered == 0)).any()), \
            f"R-MAT {scale}: the set is not maximal"
        digest = hashlib.sha256(members.astype(np.int64).tobytes()
                                ).hexdigest()[:16]
        assert (len(members), digest) == MIS_ANCHORS[scale], \
            (scale, len(members), digest)
        mis_info[scale] = (len(members), secs)
    n12 = 1 << 12
    I12, J12 = gt.symmetrize_pattern(*gt.rmat_edges(12, 16, seed=7), n12)
    X12 = np.ones(len(I12), bool)
    runs12 = []
    for dev in ("cuda", "cpu"):     # the card, then the port on the CPU
        A12c = gt.CsrMatrix.from_coo(I12, J12, X12, n12, n12, type=gt.BOOL,
                                     sum_duplicates=False, device=dev)
        A12 = gt.Matrix.from_coo(I12, J12, X12, n12, n12, type=gt.BOOL,
                                 device=dev)
        runs12.append((gt.models.mis(A12c, seed=42).extractTuples(),
                       gt.models.dpagerank(A12), gt.models.ipagerank(A12)))
    (mis_card, dcard, icard), (mis_cpu, dcpu, icpu) = runs12
    assert all(np.array_equal(a, b) for a, b in zip(mis_card, mis_cpu)), \
        "mis on the card != the port's CPU run at R-MAT 12"
    assert icard == icpu, "ipagerank on the card != the CPU run"
    dref = np.zeros(n12)
    for p, v in dcpu:
        dref[p] = v
    check_ranks(dcard, dref, rtol=1e-12)
    for ranks in (dcard, icard):
        assert [p for p, _ in ranks[:10]] == RMAT12_PAGERANK_TOP10
    pr_times = {}
    rd14, ri14 = pagerank_oracles(I14, J14, n14)
    for name, want, rtol in (("dpagerank", rd14, 1e-9),
                             ("ipagerank", ri14, None)):
        fn = getattr(gt.models, name)
        ranks, first = timed(lambda: fn(A14))
        _, warm = timed(lambda: fn(A14))
        check_ranks(ranks, want, rtol)
        pr_times[name] = (first, warm, [p for p, _ in ranks[:10]])
    sync()
    mis_pr_launches = path_counts()
    for scale, (size, secs) in mis_info.items():
        print(f"{tag} phase25 mis on CSR R-MAT {scale}: |iset| {size} == "
              f"the JAX package's set, independent and maximal; "
              f"{secs:.3f} s")
    print(f"{tag} phase25 R-MAT 12: mis (|iset| {len(mis_card[0])}) "
          f"and ipagerank == the port's CPU run, dpagerank within rtol "
          f"1e-12 of it, top-10 {RMAT12_PAGERANK_TOP10}")
    for name, (first, warm, top) in pr_times.items():
        how = ("uint64 exactly" if name == "ipagerank"
               else "float64 within rtol 1e-9")
        print(f"{tag} phase25 {name} on bitmap R-MAT 14: == scipy {how}, "
              f"descending, top-10 {top}; first {first:.4f} s, warm "
              f"{warm:.4f} s")
    print(f"{tag} phase25 phase {time.perf_counter() - t_phase:.3f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated()} B")
    print(f"models-mis-pagerank-path launches: {json.dumps(mis_pr_launches)}")
    path_launches["models_mis_pagerank"] = mis_pr_launches

    # ---- the hypersparse containers at 2^60: 26-27 ----
    # (no kernel lies on these paths; every count is read and printed)
    # 26. the R-MAT 18 graph with INT64 values U{1..99} mapped into the
    # 2^60 id space by a strictly increasing map: build, 10,000
    # setElement calls + wait, transpose, select(tril), eWiseAdd of L and
    # U, reduce_to_vector(plus) into a SparseVec, extract and a masked
    # assign on 2^16 random vertices; each result == a scipy rebuild in
    # the compact id space, mapped back
    t_phase = time.perf_counter()
    dim = gt.GxB_INDEX_MAX
    ids18 = id_map(n)
    rng26 = np.random.default_rng(26)
    X26 = rng26.integers(1, 100, len(I18)).astype(np.int64)
    S26 = scipy_rebuild(lin18, X26, n, n)
    e64 = np.zeros(0, np.int64)

    def hyper_empty(t, m):
        return gt.hyper_from_coo(e64, e64, np.zeros(0, t.dtype), m, m,
                                 type=t, device="cuda")
    _build.reset_launches()
    op_times = {}

    def first_warm(name, fn):
        out, first = timed(fn)
        _, warm = timed(fn)
        op_times[name] = (first, warm)
        return out
    H = first_warm("hyper_from_coo", lambda: gt.hyper_from_coo(
        ids18[I18], ids18[J18], X26, dim, dim, type=gt.INT64, dup=None,
        device="cuda"))
    same_hyper(H, S26, ids18, ids18, "hyper_from_coo vs scipy")
    k26 = 10_000
    old = rng26.integers(0, len(I18), k26 // 2)
    ui = np.concatenate([I18[old], rng26.integers(0, n, k26 - k26 // 2)])
    uj = np.concatenate([J18[old], rng26.integers(0, n, k26 - k26 // 2)])
    ux = rng26.integers(-50, 50, k26)
    order = rng26.permutation(k26)
    ui, uj, ux = ui[order], uj[order], ux[order]
    use_acc = (np.arange(k26) // 1_000) % 2 == 1
    plus64 = gt.binary.plus[gt.INT64]

    def set_all():
        B = H
        for e in range(k26):
            B = B.setElement(np.int64(ux[e]), int(ids18[ui[e]]),
                             int(ids18[uj[e]]),
                             accum=plus64 if use_acc[e] else None)
        return B
    B = first_warm(f"setElement x{k26}", set_all)
    assert len(B._pending) == k26 and not H._pending
    W = first_warm("wait", B.wait)
    state = replay_pending(lin18, X26, ui * n + uj, ux, use_acc)
    skeys = np.fromiter(state, np.int64, len(state))
    svals = np.fromiter(state.values(), np.int64, len(state))
    keep = ~np.isin(lin18, skeys)
    lin_w = np.concatenate([lin18[keep], skeys])
    val_w = np.concatenate([X26[keep], svals])
    Wsp = scipy_rebuild(lin_w, val_w, n, n)
    same_hyper(W, Wsp, ids18, ids18, "setElement + wait vs scipy")
    Cn = hyper_empty(gt.INT64, dim)
    T = first_warm("transpose", lambda: gt.transpose(Cn, None, None, W))
    same_hyper(T, Wsp.T, ids18, ids18, "transpose vs scipy")
    import scipy.sparse as ssp
    Lh = first_warm("select(tril)", lambda: gt.select(
        Cn, None, None, gt.selectop.tril, W, 0))
    same_hyper(Lh, ssp.tril(Wsp), ids18, ids18, "select(tril) vs scipy")
    Ls = gt.select(Cn, None, None, gt.selectop.tril, W, -1)
    Us = gt.select(Cn, None, None, gt.selectop.triu, W, 1)
    P = first_warm("eWiseAdd(L, U)", lambda: gt.eWiseAdd(
        Cn, None, None, plus64, Ls, Us))
    Wc = Wsp.tocoo()
    off = Wc.row != Wc.col              # explicit zeros kept
    same_hyper(P, scipy_rebuild(Wc.row[off].astype(np.int64) * n
                                + Wc.col[off], Wc.data[off], n, n),
               ids18, ids18, "eWiseAdd of L and U vs scipy")
    w0 = gt.SparseVec.from_coo(e64, e64, dim, type=gt.INT64, device="cuda")
    r = first_warm("reduce_to_vector(plus)", lambda: gt.reduce_to_vector(
        w0, None, None, gt.monoid.plus[gt.INT64], W))
    rsum = np.asarray(Wsp.sum(axis=1)).ravel()
    nz = np.nonzero(np.diff(Wsp.indptr))[0]
    ri, rx = r.extractTuples()
    assert np.array_equal(ri, ids18[nz]) and np.array_equal(rx, rsum[nz]), \
        "reduce_to_vector(plus) vs scipy"
    S = rng26.choice(n, 1 << 16, replace=False)
    m = len(S)
    G = first_warm("extract", lambda: gt.extract(
        hyper_empty(gt.INT64, m), None, None, W, ids18[S], ids18[S]))
    local = np.arange(m)
    same_hyper(G, Wsp[S][:, S], local, local,
               "extract of the induced subgraph vs scipy")
    D = gt.apply(G, None, plus64, gt.unary.identity[gt.INT64], G)  # 2 G
    Mh = gt.hyper_from_coo(ids18[I18], ids18[J18], np.ones(len(I18), bool),
                           dim, dim, type=gt.BOOL, dup=None, device="cuda")
    C26 = first_warm("assign<M>", lambda: gt.assign(
        W, Mh, None, D, ids18[S], ids18[S]))
    Dh = D.extractTuples()
    dlin = S[Dh[0]] * n + S[Dh[1]]
    ins = np.zeros(n, bool)
    ins[S] = True
    in_reg = ins[lin_w // n] & ins[lin_w % n]
    zl = np.concatenate([lin_w[~in_reg], dlin])
    zv = np.concatenate([val_w[~in_reg], Dh[2]])
    zm = np.isin(zl, lin18)
    wm = np.isin(lin_w, lin18)
    same_hyper(C26, scipy_rebuild(np.concatenate([zl[zm], lin_w[~wm]]),
                                  np.concatenate([zv[zm], val_w[~wm]]),
                                  n, n), ids18, ids18,
               "assign<M> of the doubled subgraph vs scipy")
    sync()
    hyper_ops_launches = path_counts()
    for name, (first, warm) in op_times.items():
        print(f"{tag} phase26 {name}: first {first:.4f} s, warm "
              f"{warm:.4f} s")
    print(f"{tag} phase26 R-MAT 18 INT64 in the 2^60 id space ("
          f"{len(I18)} entries, {H.nvec} present rows): {k26} setElement "
          f"+ wait -> {W.nvals}, transpose, select(tril) -> {Lh.nvals}, "
          f"eWiseAdd(L, U) -> {P.nvals}, reduce_to_vector -> {r.nvals} "
          f"rows, extract of {m} ids -> {G.nvals}, assign<M> -> "
          f"{C26.nvals}: each == the scipy rebuild mapped back; phase "
          f"{time.perf_counter() - t_phase:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    del H, B, W, T, Lh, Ls, Us, P, G, D, Mh, C26, Wsp, S26, state

    # 27. the models at 2^60: BFS from id[0] by the bfs5m loop on the
    # BOOL R-MAT 18 (SparseVec frontier, vxm over lor_land with the
    # complemented structural visited mask and REPLACE, eWiseAdd into
    # visited) == the anchor; the masked SandiaDot count at R-MAT 14
    # into a hypersparse C == tricount_esc and the anchor; the R-MAT 16
    # count mapped into [0, 2^27) over the lane cap hands off to the
    # chunked CSR ESC, and at 2^60 raises
    t_phase = time.perf_counter()
    model_times = {}
    Hb = gt.hyper_from_coo(ids18[I18], ids18[J18], np.ones(len(I18), bool),
                           dim, dim, type=gt.BOOL, dup=None, device="cuda")
    lorland = gt.semiring.lor_land[gt.BOOL]
    scmp = gt.Descriptor(mask_scmp=True, replace=True, mask_structure=True)

    def bfs_hyper(A, src):
        """{id: level} by the bfs5m loop on the hypersparse containers"""
        frontier = gt.SparseVec.from_coo(np.array([src], np.int64),
                                         np.array([True]), dim,
                                         type=gt.BOOL, device="cuda")
        visited, level, depth = frontier, {src: 1}, 1
        while frontier.nvals:
            depth += 1
            nxt = gt.vxm(gt.SparseVec.from_coo(
                e64, np.zeros(0, bool), dim, type=gt.BOOL, device="cuda"),
                visited, None, lorland, frontier, A, scmp)
            for i in nxt.ids():
                level[int(i)] = depth
            visited = gt.eWiseAdd(visited, None, None,
                                  gt.binary.lor[gt.BOOL], visited, nxt)
            frontier = nxt
        return level
    # the references run before the counted window
    want_lev = gt.bfs_csr(A18s, 0)
    n14 = 1 << 14
    A14s = gt.CsrMatrix.from_coo(I14, J14, np.ones(len(I14), bool), n14,
                                 n14, type=gt.BOOL, sum_duplicates=False,
                                 device="cuda")
    L14, U14 = gt.tricount_prep_csr(A14s)
    want14 = int(gt.tricount_esc(L14, U14))
    _build.reset_launches()
    levels, bfs_first = timed(lambda: bfs_hyper(Hb, int(ids18[0])))
    _, bfs_warm = timed(lambda: bfs_hyper(Hb, int(ids18[0])))
    model_times["bfs5m loop (SparseVec)"] = (bfs_first, bfs_warm)
    lev = np.zeros(n, np.int64)
    lev[np.searchsorted(ids18, np.fromiter(levels, np.int64))] = \
        np.fromiter(levels.values(), np.int64)
    vals, cnts = np.unique(lev, return_counts=True)
    assert dict(zip(vals.tolist(), cnts.tolist())) == RMAT18_BFS_LEVELS, \
        (vals, cnts)
    assert np.array_equal(lev, want_lev), "hyper BFS != bfs_csr"
    del Hb

    def hyper_lu(L, U, rid, bound):
        out = []
        for X in (L, U):
            i_, j_, _ = X.extractTuples()
            out.append(gt.hyper_from_coo(rid[i_], rid[j_],
                                         np.ones(len(i_), np.int64), bound,
                                         bound, type=gt.INT64, dup=None,
                                         device="cuda"))
        return out
    plus_times64 = gt.semiring.plus_times[gt.INT64]
    tran1 = gt.Descriptor(tran1=True)

    def hyper_count(Lh, Uh, bound):
        C = gt.mxm(hyper_empty(gt.INT64, bound), Lh, None, plus_times64, Lh,
                   Uh, tran1)
        return int(gt.reduce_to_scalar(None, gt.monoid.plus[gt.INT64], C))
    L14h, U14h = hyper_lu(L14, U14, id_map(n14), dim)
    ntri14, c_first = timed(lambda: hyper_count(L14h, U14h, dim))
    engine14 = gt.last_axb_method()
    ntri14b, c_warm = timed(lambda: hyper_count(L14h, U14h, dim))
    model_times["masked count R-MAT 14"] = (c_first, c_warm)
    assert ntri14 == ntri14b == want14 == RMAT14_NTRI, \
        (ntri14, ntri14b, want14)
    assert engine14 == "esc:hyper_spgemm", engine14
    L16, U16 = graphs[16][0], graphs[16][1]
    n16 = L16.nrows
    L27, U27 = hyper_lu(L16, U16, id_map(n16, 1 << 27), 1 << 27)
    ntri16, h_first = timed(lambda: hyper_count(L27, U27, 1 << 27))
    engine16 = gt.last_axb_method()
    model_times["hand-off R-MAT 16 in 2^27"] = (h_first, None)
    assert ntri16 == RMAT_ANCHORS[16][1], ntri16
    assert engine16 == "esc:chunked", engine16
    del L27, U27
    L60, U60 = hyper_lu(L16, U16, id_map(n16), dim)
    try:
        hyper_count(L60, U60, dim)
        raise AssertionError("the 2^60 product over the lane cap ran")
    except NotImplementedError as err:
        assert "lane cap" in str(err), err
    del L60, U60
    sync()
    hyper_models_launches = path_counts()
    for name, (first, warm) in model_times.items():
        print(f"{tag} phase27 {name}: first {first:.4f} s" +
              (f", warm {warm:.4f} s" if warm is not None else ""))
    print(f"{tag} phase27 BFS from id[0] on the BOOL R-MAT 18 in the 2^60 "
          f"id space: levels == {RMAT18_BFS_LEVELS} == bfs_csr; R-MAT 14 "
          f"masked count into a hypersparse C via {engine14}: {ntri14} == "
          f"tricount_esc == the anchor; R-MAT 16 in [0, 2^27) via "
          f"{engine16}: {ntri16}; at 2^60 it raises NotImplementedError "
          f"(lane cap); phase {time.perf_counter() - t_phase:.3f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated()} B")
    path_launches["hyper"] = {
        k_: hyper_ops_launches[k_] + hyper_models_launches[k_]
        for k_ in KERNELS}
    print(f"hyper-path launches: {json.dumps(path_launches['hyper'])}")

    # ---- user-defined types and the complex types: 28-29 ----
    # (no kernel lies on these paths: every gate refuses struct and
    # complex operands; each path is counted from zero and printed)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, _, _, A12 = rmat_lu(gt, 12)
    path_launches["udt"], _ = phase28_udt(
        gt, graphs[16][0], graphs[16][1], graphs[18][3], A12, "cuda", tag,
        ntri16=RMAT_ANCHORS[16][1])
    print(f"{tag} phase28 phase {time.perf_counter() - t_phase:.3f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated()} B")
    print(f"udt-path launches: {json.dumps(path_launches['udt'])}")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    path_launches["complex"], _ = phase29_complex(
        gt, graphs[16][0], graphs[16][1], valued[16][5], graphs[18][3], A12,
        "cuda", tag, nnzc16=VALUED_NNZC[16])
    print(f"{tag} phase29 phase {time.perf_counter() - t_phase:.3f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated()} B")
    print(f"complex-path launches: {json.dumps(path_launches['complex'])}")
    del A12

    sources = {
        "tri_band_ring": ("graphblas_tpu_torch/csrc/window.cu",
                          "graphblas_tpu/sparse/pallas_window.py:160"),
        "window_count": ("graphblas_tpu_torch/csrc/window.cu",
                         "graphblas_tpu/sparse/pallas_window.py:63"),
        "bitdot_popcount": ("graphblas_tpu_torch/csrc/bitdot.cu",
                            "graphblas_tpu/sparse/bitdot.py:401"),
        "valdot_gatherdot_rows": ("graphblas_tpu_torch/csrc/valdot.cu",
                                  "graphblas_tpu/sparse/valdot.py:481"),
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
        entry.update(extra_of.get(name, {}))
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
