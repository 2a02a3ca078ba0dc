"""Slab-width (S) sweep of the value-panel engine.

Counterpart of ``tools/valdot_sweep.py``.  For each slab width S it
builds ``build_valdot_plan(M, L, U, plus_times[FP32], level_cols=S)``
on the degree-prepped R-MAT graph with bench.py's values, seeds the
plan cache on M as ``valdot_masked_spgemm`` would (the key
``("valdot_plan", "FP32", "FP32")``: four weak references, then the
plan), so the public entry runs that plan, and times the warm call as
the best of 3, each ending in a device synchronize.  A wider slab
gathers fewer, longer rows per live lane; a narrower one keeps the live
lists finer.  Every width must give the first width's nnzC, and its
value sum within 1e-4 relative.  One JSON line per S (the JAX tool's
keys, plus ``"device"``).

    python -m graphblas_tpu_torch.tools.valdot_sweep [scale] [S...]
        [--device cpu]

Default: scale 16, S in 1024 2048 4096 8192.  Runs on the card unless
given ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import time
import weakref

import numpy as np

from ..core.semirings import semiring
from ..core.types import FP32
from ..sparse import valdot as vd
from ..sparse.container import CsrMatrix, resolve_device
from ..sparse.tri import tricount_prep_csr
from .scale_run import build as build_graph
from .scale_run import emit, sync

__all__ = ["WIDTHS", "build", "valued", "sweep", "main"]

WIDTHS = (1024, 2048, 4096, 8192)

#: the plan cache's key on M for FP32 x FP32 operands
PLAN_KEY = ("valdot_plan", "FP32", "FP32")


def valued(L: CsrMatrix, U: CsrMatrix):
    """(Lv, Uv, Mv): bench.py's values on the prepped factors' patterns
    (``default_rng(3)``, U[0.5, 1.5) float32 for L, then U, then M on
    L's pattern), read from ``host_pattern``."""
    rv = np.random.default_rng(3)

    def withvals(X):
        hp = X._options["host_pattern"]
        Iv, Jv = hp[0][:X.nvals], hp[1][:X.nvals]
        return CsrMatrix.from_coo(
            Iv, Jv, rv.random(len(Iv)).astype(np.float32) + 0.5,
            X.nrows, X.ncols, type=FP32, sum_duplicates=False,
            device=X.device)
    return withvals(L), withvals(U), withvals(L)


def build(scale: int, device=None):
    """(Lv, Uv, Mv) of the R-MAT graph at ``scale`` on ``device``."""
    A, _, _ = build_graph(scale, device)
    return valued(*tricount_prep_csr(A))


def sweep(Lv: CsrMatrix, Uv: CsrMatrix, Mv: CsrMatrix, widths, scale: int):
    """(records, C): one record a width (printed as a JSON line) and the
    product of the last width that planned (None if none did); asserts
    that every width gives the first width's nnzC and value sum."""
    dev = Mv.device
    srv = semiring.plus_times[FP32]
    ref = C = None
    recs = []
    for S in widths:
        t0 = time.perf_counter()
        plan = vd.build_valdot_plan(Mv, Lv, Uv, srv, level_cols=S)
        sync(dev)
        plan_s = time.perf_counter() - t0
        if plan is None:
            recs.append(emit({"scale": scale, "S": S, "plan": None}, dev))
            continue
        # seed the cache so the public entry runs THIS plan
        Mv._options[PLAN_KEY] = (
            weakref.ref(Lv.indices), weakref.ref(Lv.values),
            weakref.ref(Uv.indices), weakref.ref(Uv.values), plan)
        C = vd.valdot_masked_spgemm(srv, Lv, Uv, Mv)
        warm = float("inf")
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            C2 = vd.valdot_masked_spgemm(srv, Lv, Uv, Mv)
            sync(dev)
            warm = min(warm, time.perf_counter() - t0)
        assert C2.nvals == C.nvals, (S, C2.nvals, C.nvals)
        s = float(C.values[:C.nvals].double().sum())
        if ref is None:
            ref = (C.nvals, s)
        else:
            assert C.nvals == ref[0], (S, C.nvals, ref[0])
            assert abs(s - ref[1]) <= 1e-4 * abs(ref[1]), (S, s, ref)
        flops = plan.covered_lanes + plan.light_lanes
        recs.append(emit({
            "scale": scale, "S": S, "levels": len(plan.levels),
            "sum_nlive": int(sum(lv.nlive for lv in plan.levels)),
            "kcut": plan.kcut,
            "cov_pct": 100.0 * plan.covered_lanes / flops,
            "light_lanes": plan.light_lanes,
            "plan_s": plan_s, "warm_s": warm,
            "mflops_per_s": flops / warm / 1e6,
            "nnzC": C.nvals,
        }, dev))
    return recs, C


def main(argv=None) -> list:
    """Sweep the widths at one scale; returns the records."""
    p = argparse.ArgumentParser(prog="valdot_sweep", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("scale", nargs="?", type=int, default=16)
    p.add_argument("widths", nargs="*", type=int, default=list(WIDTHS))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    return sweep(*build(args.scale, dev), args.widths, args.scale)[0]


if __name__ == "__main__":
    main()
