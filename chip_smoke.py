#!/usr/bin/env python3
"""Drive the PyTorch port's triangle-counting main path once on one
CUDA card, and check each hand-written kernel against its plain PyTorch
version.

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
   shapes.

Launch counters are zeroed just before phase 3 and read just after
phase 6: every kernel must have launched there.  The line before the
last is the per-kernel JSON summary; the last line is
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


def compare_timed(kernel, plain, reps: int):
    """Exact comparison, then device times in turns: plain, kernel,
    kernel, plain.  Returns (max_abs_err, kernel_ms, plain_ms)."""
    err = max_abs_err(kernel(), plain())
    if err:
        raise AssertionError(f"kernel differs from plain version by {err}")
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return err, min(k1, k2), min(p1, p2)


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
    n = 1 << scale
    I, J = gt.rmat_edges(scale, 16, seed=7)
    I, J = gt.symmetrize_pattern(I, J, n)
    A = gt.CsrMatrix.from_coo(I, J, np.ones(len(I), bool), n, n,
                              type=gt.BOOL, sum_duplicates=False,
                              device="cuda")
    L, U = gt.tricount_prep_csr(A)
    return L, U, len(I)


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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    card = card_label()
    print(card, flush=True)
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import _build
    from graphblas_tpu_torch.sparse import bitdot as bd
    from graphblas_tpu_torch.sparse import cuda_window as cw
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
    summary["window_count"] = compare_timed(
        lambda: gt.window_count_partials(win),
        lambda: cw._window_count_plain(win.P, win.Q, win.M), 5)
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
    print(f"{tag} phase4 Wathen 384: n {n}, {nnz} entries, Wb {band.Wb}, "
          f"panels {band.panel_bytes} B; {ntri} triangles via {engine} "
          f"(first {first:.4f} s, warm {warm:.6f} s) == tricount_esc via "
          f"{esc_engine} (first {esc_first:.4f} s, warm {esc_warm:.6f} s)")
    del L, U, band

    # 5-6. R-MAT: the power-law regime
    plan18 = None
    for phase, scale in ((5, 16), (6, 18)):
        t0 = time.perf_counter()
        L, U, nnz = rmat_lu(gt, scale)
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
    sync()
    launches = dict(_build.launches)
    print(f"main-path launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

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
    sync()

    sources = {
        "tri_band_ring": ("graphblas_tpu_torch/csrc/window.cu",
                          "graphblas_tpu/sparse/pallas_window.py:156"),
        "window_count": ("graphblas_tpu_torch/csrc/window.cu",
                         "graphblas_tpu/sparse/pallas_window.py:59"),
        "bitdot_popcount": ("graphblas_tpu_torch/csrc/bitdot.cu",
                            "graphblas_tpu/sparse/bitdot.py:401"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        err, ms, pms = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
