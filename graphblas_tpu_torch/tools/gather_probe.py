"""Gather probe (P1): how fast the card gathers inside row windows and
from a flat table.

Counterpart of ``tools/gather_probe.py``, which asked what random
gather a TPU kernel can do (Mosaic offered a 128-lane shuffle and an
8-row tile gather and refused wider forms).  Here every form runs
through one hand-written kernel (``gb_row_gather`` in
``csrc/probes.cu``): ``out[r, l] = x[r, idx[r, l]]``, each warp staging
its row's window in shared memory.  ``torch.take_along_dim`` is its
plain version; the flat gather ``torch.take`` is timed as the library's
scalar gather.

    python -m graphblas_tpu_torch.tools.gather_probe

prints one JSON line per probe (device times by CUDA events, best of
the turns) and exits nonzero without a CUDA card.

Measured answer (NVIDIA H100 80GB HBM3, 700.00 W power limit; this
probe's ``run()`` and ``chip_smoke.py`` phase 18, CUDA events): the row
window gather at the TPU probe's shape (2^15 rows x 128, 128 indices
per row) takes 0.026-0.043 ms over two runs, 98-164 G gathers/s or
1.2-2.0 TB/s of x, idx and out (1.7-2.8x its 0.0150 ms bytes bound, a
50 MB problem); ``torch.take_along_dim`` takes 0.054 ms.  ``torch.take``
of 2^22 random entries of a 2^18-entry table runs at 108 G gathers/s.
The forms Mosaic refused (a 512-wide window with 128 indices; a 64-row
axis-0 gather, run as its transpose) take the same kernel and agree
with ``take_along_dim`` (0.026-0.042 ms each, launch-bound at this size).
On this card a random scalar gather is a memory-bandwidth question, not
a wall: the layouts that the TPU's gather limit forced (bitmap panels,
dense windows) are kept because they move fewer bytes, not because a
gather is slow.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import _build

__all__ = ["row_gather", "probe_lane_shuffle", "probe_scalar_gather",
           "probe_window_forms", "run"]

#: widest row window the kernel stages (8 windows of float32 in 48 KB)
MAX_WINDOW = 1536


def _row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.take_along_dim`` with the kernel's index
    clamp into [0, Wx)."""
    return torch.take_along_dim(x, idx.long().clamp(0, x.shape[1] - 1), 1)


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, l] = x[r, idx[r, l]] for float32 x (R, Wx), Wx <= 1536,
    and int32 idx (R, L) (clamped into [0, Wx)).  CUDA tensors launch
    the kernel; CPU tensors run its plain version."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise TypeError(f"idx must be a 2-D int32 tensor, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.shape[0] != x.shape[0] or idx.device != x.device:
        raise ValueError("x and idx differ in rows or device")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    if not 0 < x.shape[1] <= MAX_WINDOW:
        raise ValueError(f"row window {x.shape[1]} outside 1..{MAX_WINDOW}")
    if x.device.type == "cpu":
        return _row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    R, L = idx.shape
    out = torch.empty((R, L), dtype=torch.float32, device=x.device)
    _build.launch("row_gather", x, x.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), R, x.shape[1], L)
    return out


def _cuda_ms(fn, reps: int) -> float:
    """Best of three runs of ``reps`` calls, device ms per call."""
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


def _case(rows: int, width: int, per_row: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((rows, width), np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(0, width, (rows, per_row),
                                        dtype=np.int32)).cuda()
    return x, idx


def probe_lane_shuffle(R: int = 1 << 15, W: int = 128, reps: int = 50):
    """The TPU probe's shape: R rows of 128-wide windows, 128 indices
    per row."""
    x, idx = _case(R, W, W)
    got = row_gather(x, idx)
    if not torch.equal(got, _row_gather_plain(x, idx)):
        raise AssertionError("row_gather differs from take_along_dim")
    ms = _cuda_ms(lambda: row_gather(x, idx), reps)
    return {"probe": "row_window_gather", "rows": R, "window": W,
            "per_row": W, "ms": ms, "g_per_s": R * W / (ms * 1e6),
            "gb_per_s": 3 * R * W * 4 / (ms * 1e6)}


def probe_scalar_gather(n: int = 1 << 18, E: int = 1 << 22,
                        reps: int = 50):
    """The library's flat gather: ``torch.take`` of E random entries of
    an n-entry table (no kernel of this repository)."""
    rng = np.random.default_rng(0)
    tbl = torch.from_numpy(rng.random(n, np.float32)).cuda()
    gi = torch.from_numpy(rng.integers(0, n, E)).cuda()
    ms = _cuda_ms(lambda: torch.take(tbl, gi), reps)
    return {"probe": "torch_take", "n": n, "E": E, "ms": ms,
            "g_per_s": E / (ms * 1e6)}


def probe_window_forms(reps: int = 50):
    """The forms Mosaic refused, through the same kernel: a 512-wide
    window with 128 indices per row, and a 64-row axis-0 gather (its
    transpose is a 64-wide window per column).  Records what the card
    does; asserts only equality with ``take_along_dim``."""
    out = {"probe": "window_forms"}
    x, idx = _case(256, 512, 128, seed=1)
    got = row_gather(x, idx)
    ok = torch.equal(got, _row_gather_plain(x, idx))
    ms = _cuda_ms(lambda: row_gather(x, idx), reps)
    out["axis1_width512_narrow_idx"] = {"equal": ok, "ms": ms}
    # out[r, l] = x0[idx0[r, l], l], indices into the 64 rows
    x0, _ = _case(64, 128, 128, seed=2)
    _, idx0 = _case(64, 64, 128, seed=3)
    xt, it = x0.t().contiguous(), idx0.t().contiguous()
    got = row_gather(xt, it).t()
    ok0 = torch.equal(got, torch.take_along_dim(x0, idx0.long(), 0))
    ms0 = _cuda_ms(lambda: row_gather(xt, it), reps)
    out["axis0_64rows"] = {"equal": ok0, "ms": ms0}
    if not (ok and ok0):
        raise AssertionError(f"window forms differ: {out}")
    return out


def run(stream=sys.stdout):
    """Every probe, one JSON line each; returns the records."""
    if not torch.cuda.is_available():
        sys.exit("gather_probe: no CUDA device; the probe measures the card")
    recs = [probe_lane_shuffle(), probe_scalar_gather(),
            probe_window_forms()]
    for r in recs:
        print(json.dumps(r), file=stream, flush=True)
    return recs


if __name__ == "__main__":
    run()
