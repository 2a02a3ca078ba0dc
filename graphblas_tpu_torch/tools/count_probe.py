"""Count-kernel probe: what sets the time of the band ring (K1) and the
window count (K2), and of the other kernels on the int8 tensor-core tile
(the window product K3 and the BSR kernel's counting form K7), on the
Wathen nx=ny=128 and 384 graphs of ``chip_smoke.py``.

    python -m graphblas_tpu_torch.tools.count_probe [--orders] [--variants]

Each measurement is a device time by CUDA events (the best of three runs
of 20 calls), after checking the kernel's result against its plain
version exactly; it prints one JSON line per package it times and exits
nonzero without a CUDA card.  It imports the package through the Python
path, so another checkout's kernels are timed by running this file from
that checkout's root:

    PYTHONPATH=. python3 <checkout>/graphblas_tpu_torch/tools/count_probe.py

``--orders`` also times K1 at Wathen 384 with its schedule's outputs in
three orders (heaviest first as built, block-row order, and heaviest
first within runs of 64 block-rows).  ``--variants`` builds this
package's sources again with one change to the tile each, under
``build/variants/``, and times each in a process of its own: a ring of 4
or 5 stages (results checked), and four ablations whose results are
wrong and not checked (no mma, no B transpose, no operand copies, no
mask), which show what each part of the tile costs.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

__all__ = ["wathen_lu", "times", "orders", "variants"]

#: edits of the tile's sources, by variant name: (file in csrc, old, new)
VARIANTS = {
    "stages4": [("mma_s8_tile.cuh", "constexpr int STAGES = 3;",
                 "constexpr int STAGES = 4;")],
    "stages5": [("mma_s8_tile.cuh", "constexpr int STAGES = 3;",
                 "constexpr int STAGES = 5;")],
    "no_mma": [("mma_s8_tile.cuh", '''  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
                "  c[0] += a[0] ^ a[3] ^ b0 ^ b1;")],
    "no_transpose": [("mma_s8_tile.cuh", '''    transpose_b(cur + A_WORDS, Bs);
    __syncthreads();
''', "")],
    "no_copy": [("mma_s8_tile.cuh",
                 "    copy_stage(a, lda, b, ldb, (g % nkc) * KC, st, "
                 "st + A_WORDS);",
                 "    if (a == nullptr) copy_stage(a, lda, b, ldb, 0, st, "
                 "st + A_WORDS);")],
    "no_mask": [("mma_s8_tile.cuh",
                 "*reinterpret_cast<const unsigned short*>(\n"
                 "            mb + 128 * r + 16 * ((c >> 4) ^ (r & 7)) + "
                 "(c & 15));", "0x0101u;"),
                ("mma_s8_tile.cuh",
                 "cp_async16(Ms + 32 * r + 4 * (c ^ (r & 7)), "
                 "Msk + (long)r * ldm + 16 * c);", "(void)Ms;")],
}
#: variants whose arithmetic is unchanged, so their results are checked
CHECKED = ("stages4", "stages5")


def wathen_lu(gt, nx: int):
    """Wathen nx x nx as strictly lower/upper BOOL CSR on the card,
    assembled as ``chip_smoke.py`` (and bench.py) do."""
    I, J, _, n = gt.wathen_coo(nx, nx, seed=1)
    ku = np.unique(I * n + J)
    iu, ju = ku // n, ku % n
    off = iu != ju
    iu, ju = iu[off], ju[off]
    out = []
    for keep in (iu > ju, iu < ju):
        out.append(gt.CsrMatrix.from_coo(
            iu[keep], ju[keep], np.ones(int(keep.sum()), bool), n, n,
            type=gt.BOOL, sum_duplicates=False, device="cuda"))
    return out[0], out[1], iu, ju, n


def _cuda_ms(fn, reps: int = 20, runs: int = 3) -> float:
    """Best device milliseconds per call over ``runs`` runs of ``reps``
    calls (after one warm call)."""
    fn()
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _check(name, got, want, checked: bool):
    if checked and not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version")


def times(checked: bool = True) -> dict:
    """Device ms of K1 at Wathen 128 and 384, K2 and K3 at Wathen 128, K7
    (counting) at both, and a warm ``tricount_auto`` at both."""
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.sparse import cuda_bsr as tcb
    from graphblas_tpu_torch.sparse import cuda_window as cw
    res = {}
    for nx in (128, 384):
        L, U, iu, ju, n = wathen_lu(gt, nx)
        band = gt.build_band_plan(L, U)
        cases = {f"K1@{nx}": (
            lambda: gt.tricount_band_partials(band),
            lambda: cw._tri_band_partials_plain(band.P, band.Ut))}
        if nx == 128:
            win = gt.build_window_plan(L, U, L)
            cases["K2@128"] = (
                lambda: gt.window_count_partials(win),
                lambda: cw._window_count_plain(win.P, win.Q, win.M))
            cases["K3@128"] = (
                lambda: gt.window_masked_mm_pallas(win),
                lambda: cw._window_mm_plain(win.P, win.Q, win.M))
        lo, up = iu > ju, iu < ju
        Lt = gt.tile_pattern_from_coo(iu[lo], ju[lo], (n, n), device="cuda")
        Bt = gt.tile_pattern_from_coo(ju[up], iu[up], (n, n), device="cuda")
        sched = [torch.from_numpy(a).to("cuda")
                 for a in tcb._schedule(Lt, Lt, Bt)[:4]]
        cases[f"K7@{nx}"] = (
            lambda: tcb.bsr_tiles_mm(*sched, Lt.tiles, Bt.tiles, Lt.tiles,
                                     torch.int32),
            lambda: tcb._bsr_mm_plain(*sched, Lt.tiles, Bt.tiles, Lt.tiles,
                                      torch.int32))
        for name, (kernel, plain) in cases.items():
            _check(name, kernel(), plain(), checked)
            res[name] = _cuda_ms(kernel)
        res[f"tricount_auto@{nx}"] = _cuda_ms(
            lambda: gt.tricount_auto(L, U), 10)
        del L, U, band, cases, Lt, Bt, sched
    return res


def _reordered(sched, perm: torch.Tensor):
    """The schedule with its outputs in the order ``perm``."""
    from graphblas_tpu_torch.sparse.window import TileSchedule
    counts = (sched.kptr[1:] - sched.kptr[:-1]).long()[perm]
    kptr = torch.zeros(perm.numel() + 1, dtype=torch.int32,
                       device=perm.device)
    kptr[1:] = torch.cumsum(counts, 0)
    first = torch.repeat_interleave(sched.kptr[:-1].long()[perm], counts)
    within = (torch.arange(int(counts.sum()), device=perm.device)
              - torch.repeat_interleave(kptr[:-1].long(), counts))
    return TileSchedule(sched.rows[perm], sched.cols[perm], kptr,
                        sched.kblk[first + within], sched.panels)


def orders() -> dict:
    """Device ms of K1 at Wathen 384 over its schedule in three orders."""
    import graphblas_tpu_torch as gt
    L, U, _, _, _ = wathen_lu(gt, 384)
    band = gt.build_band_plan(L, U)
    want = gt.tricount_band_partials(band)
    built = band.schedule
    rows, cols = built.rows.long(), built.cols.long()
    counts = (built.kptr[1:] - built.kptr[:-1]).long()
    natural = torch.argsort(rows * 4096 + cols)
    chunked = torch.argsort(((rows // 64) * 4096 - counts) * (1 << 24)
                            + rows * 64 + cols)
    res = {}
    for name, sched in (("heaviest_first", built),
                        ("block_row", _reordered(built, natural)),
                        ("heaviest_first_in_64_rows",
                         _reordered(built, chunked))):
        band.schedule = sched
        _check(name, gt.tricount_band_partials(band), want, True)
        res[f"K1@384 {name}"] = _cuda_ms(
            lambda: gt.tricount_band_partials(band))
    band.schedule = built
    return res


def variants(names=tuple(VARIANTS)) -> dict:
    """Build each variant of this package's sources under
    ``build/variants/`` and time it in a process of its own."""
    pkg = Path(__file__).resolve().parents[1]
    res = {}
    for name in names:
        root = pkg / "build" / "variants" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(pkg, root / pkg.name,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        for fname, old, new in VARIANTS[name]:
            src = root / pkg.name / "csrc" / fname
            text = src.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit not found in "
                                   f"{fname}")
            src.write_text(text.replace(old, new))
        env = dict(os.environ, PYTHONPATH=str(root))
        out = subprocess.run(
            [sys.executable, str(root / pkg.name / "tools" /
                                 "count_probe.py"), "--child", name],
            env=env, cwd=root, capture_output=True, text=True, check=True)
        res[name] = json.loads(out.stdout.strip().splitlines()[-1])
    return res


def main(argv) -> int:
    if not torch.cuda.is_available():
        sys.exit("count_probe: no CUDA device; the kernels need one")
    import graphblas_tpu_torch as gt
    if argv[:1] == ["--child"]:
        print(json.dumps(times(checked=argv[1] in CHECKED)))
        return 0
    print(json.dumps({"package": gt.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "times_ms": times()}), flush=True)
    if "--orders" in argv:
        print(json.dumps({"orders_ms": orders()}), flush=True)
    if "--variants" in argv:
        print(json.dumps({"variants_ms": variants()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
