"""Gather-dot probe (P2): does reading each A row once per run of pairs
that share it, with the B rows in flight through Hopper's bulk
asynchronous copies, beat plain synchronous loads for the value-panel
access pattern (random 4 KB rows)?

Counterpart of ``tools/gatherdot_probe.py``, which asked whether a
double-buffered DMA row-gather beats the compiler's own gather on the
TPU.  Workload: ``acc[e] = sum_s A[ai[e], s] * B[bj[e], s]`` over
E = 65,536 random pairs, tables (32,768, 1,024) float32.  The forms
compute it on the same tables:

* ``gatherdot_async``: the kernel ``gb_gatherdot_async``
  (``csrc/probes.cu``) on the pairs sorted by ``ai`` (the grouping pass,
  :func:`group_pairs`; its results scattered back to pair order), one
  producer warp a block issuing a ``cp.async.bulk`` copy a row into an
  8-stage ring of ``mbarrier``-tracked stages, each A row copied once a
  run; timed with the grouping pass and on pairs handed over grouped;
* ``valdot_gatherdot``: the gather-dot kernel K4 (``csrc/valdot.cu``),
  one warp per entry, synchronous 16-byte loads;
* ``(A[ai] * B[bj]).sum(1)``: the plain version, three library calls.

    python -m graphblas_tpu_torch.tools.gatherdot_probe

prints one JSON line per form (device ms by CUDA events, GB/s of
gathered rows, 2 * E * S * 4 bytes) and exits nonzero without a card.

Measured answer (NVIDIA H100 80GB HBM3, 700.00 W power limit;
``chip_smoke.py`` phase 18, CUDA events, best of two turns, three
runs): yes, when the pairs come grouped.  On pairs handed over sorted by
``ai`` the kernel takes 0.116-0.118 ms (4.57-4.63 TB/s of gathered
rows; 1.67-1.69x the 0.0696 ms bytes bound), K4's synchronous loads
0.157-0.160 ms in the same turns, so reading each A row once a run with
the B rows in flight is 26-27 % faster.  The grouping pass, a device
sort of the 65,536 keys, takes 0.064-0.107 ms, and with it the kernel
takes 0.184-0.191 ms: on random pairs K4 stays faster.
``torch.sparse.sampled_addmm`` over the same pairs takes 0.313-0.317 ms
and the plain version 0.836-0.846 ms.  (The two-slot ``cp.async`` ring
this kernel replaced took 0.185-0.190 ms.)
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import _build

__all__ = ["gatherdot_async", "group_pairs", "make_tables", "run", "NA",
           "S", "E"]

NA = 32768
S = 1024
E = 1 << 16

#: widest row the kernel's ring takes (64 * S bytes of shared memory)
MAX_S = 2048

#: the kernel's ring: B rows in flight a block, and as many A slots
#: (GD_STAGES in csrc/probes.cu)
RING_STAGES = 8

#: resident blocks per SM the kernel's grid aims for (three 64 KB rings)
_BLOCKS_PER_SM = 3


def _gatherdot_async_plain(A, B, ai, bj) -> torch.Tensor:
    """Plain version: ``(A[ai] * B[bj]).sum(1)`` with the kernel's row
    clamp, in chunks of entries."""
    out = torch.empty(ai.shape[0], dtype=torch.float32, device=A.device)
    step = max(1, (1 << 24) // A.shape[1])
    for s in range(0, ai.shape[0], step):
        a = A[ai[s:s + step].long().clamp(0, A.shape[0] - 1)]
        b = B[bj[s:s + step].long().clamp(0, B.shape[0] - 1)]
        out[s:s + step] = (a * b).sum(1)
    return out


def group_pairs(ai: torch.Tensor, bj: torch.Tensor):
    """The grouping pass: the pairs sorted by ``ai`` (stable), as (ai, bj,
    perm) with int32 ``perm[k]`` the original position of sorted pair
    k, where the kernel writes its result."""
    ai_s, order = torch.sort(ai, stable=True)
    return ai_s, bj[order], order.to(torch.int32)


def gatherdot_async(A: torch.Tensor, B: torch.Tensor, ai: torch.Tensor,
                    bj: torch.Tensor, grouped: bool = False) -> torch.Tensor:
    """acc[e] = sum_s A[ai[e], s] * B[bj[e], s] for float32 tables (na,
    S), (nb, S) with S % 4 == 0 and S <= 2048, int32 ai, bj (E,)
    (clamped to the rows).  CUDA tensors launch the bulk-copy kernel on
    the pairs sorted by ``ai`` (:func:`group_pairs`), each A row read once
    a run; ``grouped=True`` says the pairs come grouped already and skips
    the sort (the result is the same either way).  CPU tensors run its
    plain version."""
    for name, x, dt, dim in (("A", A, torch.float32, 2),
                             ("B", B, torch.float32, 2),
                             ("ai", ai, torch.int32, 1),
                             ("bj", bj, torch.int32, 1)):
        if x.dtype != dt or x.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D {dt} tensor, got "
                            f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.device != A.device:
            raise ValueError(f"{name} must be contiguous, on {A.device}")
    Sw = A.shape[1]
    if B.shape[1] != Sw or ai.shape != bj.shape:
        raise ValueError("A and B differ in width, or ai and bj in length")
    if Sw % 4 or not 0 < Sw <= MAX_S:
        raise ValueError(f"row width {Sw} must be a multiple of 4 in "
                         f"4..{MAX_S}")
    if A.device.type == "cpu":
        return _gatherdot_async_plain(A, B, ai, bj)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if A.data_ptr() % 16 or B.data_ptr() % 16:
        raise ValueError("the kernel takes tables that start 16-byte "
                         "aligned")
    n = ai.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    perm = None
    if not grouped:
        ai, bj, perm = group_pairs(ai, bj)
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    blocks = max(1, min(n, sms * _BLOCKS_PER_SM))
    _build.launch("gatherdot_async", A, A.data_ptr(), B.data_ptr(),
                  ai.data_ptr(), bj.data_ptr(),
                  None if perm is None else perm.data_ptr(), out.data_ptr(),
                  n, A.shape[0], B.shape[0], Sw, blocks)
    return out


def make_tables(device, seed: int = 0):
    """The TPU probe's tables and random pairs, from ``seed``."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.random((NA, S), np.float32)).to(device)
    B = torch.from_numpy(rng.random((NA, S), np.float32)).to(device)
    ai = torch.from_numpy(rng.integers(0, NA, E).astype(np.int32))
    bj = torch.from_numpy(rng.integers(0, NA, E).astype(np.int32))
    return A, B, ai.to(device), bj.to(device)


def _cuda_ms(fn, reps: int) -> float:
    fn()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def run(stream=sys.stdout, reps: int = 20):
    """The forms on the same tables, one JSON line each, checked against
    a float64 sum (each entry within S * 2^-24 * sum |a * b|); returns
    the records.  ``tma_ring`` includes the grouping pass;
    ``tma_ring_pregrouped`` takes the pairs sorted by ai already (its
    results in that order)."""
    if not torch.cuda.is_available():
        sys.exit("gatherdot_probe: no CUDA device; the probe measures the "
                 "card")
    from ..sparse.valdot import valdot_gatherdot
    A, B, ai, bj = make_tables("cuda")
    ref = _gatherdot_async_plain(A.double(), B.double(), ai, bj)
    ai_g, bj_g, perm = group_pairs(ai, bj)
    forms = {"tma_ring": (lambda: gatherdot_async(A, B, ai, bj), ref),
             "tma_ring_pregrouped": (
                 lambda: gatherdot_async(A, B, ai_g, bj_g, grouped=True),
                 ref[perm.long()]),
             "valdot_k4_sync": (
                 lambda: valdot_gatherdot(A, B, ai, bj, E), ref),
             "plain_torch": (
                 lambda: _gatherdot_async_plain(A, B, ai, bj), ref)}
    recs = []
    for name, (fn, want) in forms.items():
        err = (fn().double() - want).abs()
        tol = S * 2.0 ** -24 * want   # every term is positive
        if bool((err > tol).any()):
            raise AssertionError(f"{name} beyond the bound: {err.max()}")
        ms = _cuda_ms(fn, reps)
        recs.append({"probe": "gatherdot", "form": name, "NA": NA, "S": S,
                     "E": E, "ms": ms,
                     "gb_per_s": 2 * E * S * 4 / (ms * 1e6),
                     "max_abs_err": float(err.max())})
    for r in recs:
        print(json.dumps(r), file=stream, flush=True)
    return recs


if __name__ == "__main__":
    run()
