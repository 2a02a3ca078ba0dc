"""Gather-dot probe (P2): does staging the gathered rows through a
shared-memory ring with ``cp.async`` beat plain synchronous loads for
the value-panel access pattern (random 4 KB rows)?

Counterpart of ``tools/gatherdot_probe.py``, which asked whether a
double-buffered DMA row-gather beats the compiler's own gather on the
TPU.  Workload: ``acc[e] = sum_s A[ai[e], s] * B[bj[e], s]`` over
E = 65,536 random pairs, tables (32,768, 1,024) float32.  Three forms
compute it on the same tables:

* ``gatherdot_async``: the kernel ``gb_gatherdot_async``
  (``csrc/probes.cu``), one block per entry at a time, both rows of the
  next entry copied into a two-slot shared-memory ring with
  ``cp.async`` while the current one is reduced;
* ``valdot_gatherdot``: the gather-dot kernel K4 (``csrc/valdot.cu``),
  one warp per entry, synchronous 16-byte loads;
* ``(A[ai] * B[bj]).sum(1)``: the plain version, three library calls.

    python -m graphblas_tpu_torch.tools.gatherdot_probe

prints one JSON line per form (device ms by CUDA events, GB/s of
gathered rows, 2 * E * S * 4 bytes) and exits nonzero without a card.

Measured answer (NVIDIA H100 80GB HBM3, 700.00 W power limit; this
probe's ``run()`` and ``chip_smoke.py`` phase 18, CUDA events): no.  The
``cp.async`` ring takes 0.185-0.190 ms (2.83-2.90 TB/s of gathered
rows), K4's synchronous 16-byte loads 0.160-0.165 ms (3.26-3.36 TB/s),
so K4 is 15-16 % faster; the plain version takes 0.844-0.865 ms and
``torch.sparse.sampled_addmm`` over the same pairs 0.316 ms.  The bytes
bound is 0.070 ms (about 57 k distinct 4 KB rows read once), so both
kernels read many rows twice, from L2.  With one warp per pair and many
warps resident, K4 already keeps enough loads in flight to cover the
memory latency; staging through shared memory only adds a copy and a
block-wide barrier per pair.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import _build

__all__ = ["gatherdot_async", "make_tables", "run", "NA", "S", "E"]

NA = 32768
S = 1024
E = 1 << 16

#: widest row the kernel's ring takes (16 * S bytes within 48 KB)
MAX_S = 2048

#: resident blocks per SM the kernel's grid aims for
_BLOCKS_PER_SM = 12


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


def gatherdot_async(A: torch.Tensor, B: torch.Tensor, ai: torch.Tensor,
                    bj: torch.Tensor) -> torch.Tensor:
    """acc[e] = sum_s A[ai[e], s] * B[bj[e], s] for float32 tables (na,
    S), (nb, S) with S % 4 == 0 and S <= 2048, int32 ai, bj (E,)
    (clamped to the rows).  CUDA tensors launch the cp.async kernel; CPU
    tensors run its plain version."""
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
    n = ai.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    blocks = max(1, min(n, sms * _BLOCKS_PER_SM))
    _build.launch("gatherdot_async", A, A.data_ptr(), B.data_ptr(),
                  ai.data_ptr(), bj.data_ptr(), out.data_ptr(), n,
                  A.shape[0], B.shape[0], Sw, blocks)
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
    """The three forms on the same tables, one JSON line each, checked
    against a float64 sum (each entry within S * 2^-24 * sum |a * b|);
    returns the records."""
    if not torch.cuda.is_available():
        sys.exit("gatherdot_probe: no CUDA device; the probe measures the "
                 "card")
    from ..sparse.valdot import valdot_gatherdot
    A, B, ai, bj = make_tables("cuda")
    ref = _gatherdot_async_plain(A.double(), B.double(), ai, bj)
    forms = {"cp_async_ring": lambda: gatherdot_async(A, B, ai, bj),
             "valdot_k4_sync": lambda: valdot_gatherdot(A, B, ai, bj, E),
             "plain_torch": lambda: _gatherdot_async_plain(A, B, ai, bj)}
    tol = S * 2.0 ** -24 * ref   # every term is positive
    recs = []
    for name, fn in forms.items():
        err = (fn().double() - ref).abs()
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
