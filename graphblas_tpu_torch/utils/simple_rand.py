"""Portable deterministic PRNG matching the reference demos' generator.

The reference demos seed a POSIX.1-2001 example LCG so that demo outputs
are bit-reproducible across machines (``Demo/Source/simple_rand.c``).  We
reimplement the same recurrence (state' = state*1103515245 + 12345;
output = (state/65536) % 32768) so wathen/random-matrix/MIS inputs can be
regenerated identically for golden-output parity tests.  Vectorized batch
variants produce the same streams fast on the host, and
:meth:`SimpleRand.rand_x_tensor` draws the same ``simple_rand_x`` stream
on a torch device by jump-ahead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["SimpleRand"]

_A = np.uint64(1103515245)
_C = np.uint64(12345)
_MAX = 32767  # SIMPLE_RAND_MAX
_M64 = 1 << 64


def _signed(u: int) -> int:
    """A uint64 as the int64 of the same bits."""
    return u - _M64 if u >= 1 << 63 else u


def _jump(k: int) -> tuple:
    """(a, c): k steps of the LCG as one affine map s -> a*s + c mod
    2^64, by binary powers of the one-step map (Python integers)."""
    a, c = 1, 0
    pa, pc = int(_A), int(_C)
    while k:
        if k & 1:
            a, c = pa * a % _M64, (pa * c + pc) % _M64
        pa, pc = pa * pa % _M64, (pa * pc + pc) % _M64
        k >>= 1
    return a, c


@functools.lru_cache(maxsize=4)
def _step_maps(steps: int, device: torch.device) -> tuple:
    """int64 tensors (a, c) of length ``steps`` on ``device``: entry m-1
    is the map of m LCG steps, in wrapping int64 (the bits of the uint64
    map); and the chain's weights 32767^4..1, which fit in int64.  Built
    by prefix doubling: the maps of L+1..2L steps are the map of L steps
    after those of 1..L.  Constants of the generator, so kept for the
    next draws of as many steps (callers read them, never write them)."""
    # filled on the device: a copy from the host would wait for the card
    a = torch.full((1,), _signed(int(_A)), dtype=torch.int64, device=device)
    c = torch.full((1,), _signed(int(_C)), dtype=torch.int64, device=device)
    while a.numel() < steps:
        aL, cL = a[-1], c[-1]
        a, c = torch.cat([a, aL * a]), torch.cat([c, aL * c + cL])
    w = torch.full((5,), _MAX, dtype=torch.int64, device=device).pow(
        torch.arange(4, -1, -1, device=device))
    return a[:steps], c[:steps], w


class SimpleRand:
    """Stateful clone of the reference's simple_rand stream."""

    def __init__(self, seed: int = 1):
        self.state = np.uint64(seed)

    def seed(self, seed: int):
        self.state = np.uint64(seed)

    def rand(self) -> int:
        """One draw in [0, 32767] (simple_rand())."""
        with np.errstate(over="ignore"):
            self.state = self.state * _A + _C
        return int((self.state // np.uint64(65536)) % np.uint64(_MAX + 1))

    def rand_i(self) -> np.uint64:
        """A random uint64 (simple_rand_i(): 5 chained draws, wrapping
        mod 2^64 exactly as C uint64 arithmetic does)."""
        i = np.uint64(0)
        with np.errstate(over="ignore"):
            for _ in range(5):
                i = i * np.uint64(_MAX) + np.uint64(self.rand())
        return i

    def rand_x(self) -> float:
        """A random double in [0, 1] (simple_rand_x())."""
        return float(np.uint64(self.rand_i())) / float(np.iinfo(np.uint64).max)

    # -- vectorized batch draws (same stream, computed in one numpy pass) ----
    def rand_batch(self, n: int) -> np.ndarray:
        """n consecutive simple_rand() draws, vectorized.

        The LCG recurrence state_k = A^k s0 + C (A^{k-1}+...+1) is computed
        with cumulative products mod 2^64 via repeated squaring per element;
        for typical n we just run the scalar recurrence in a tight loop —
        numpy scalars in a loop are slow, so use the matrix-free scan below.
        """
        out = np.empty(n, dtype=np.uint64)
        s = self.state
        with np.errstate(over="ignore"):
            for k in range(n):
                s = s * _A + _C
                out[k] = s
        self.state = s
        return ((out // np.uint64(65536)) % np.uint64(_MAX + 1))

    def rand_x_batch(self, n: int) -> np.ndarray:
        """n consecutive simple_rand_x() draws (wrapping uint64 chain)."""
        draws = self.rand_batch(5 * n).reshape(n, 5).astype(np.uint64)
        i = np.zeros(n, dtype=np.uint64)
        with np.errstate(over="ignore"):
            for k in range(5):
                i = i * np.uint64(_MAX) + draws[:, k]
        return i.astype(np.float64) / float(np.iinfo(np.uint64).max)

    def rand_x_tensor(self, n: int, device) -> torch.Tensor:
        """``rand_x_batch(n)`` as a float64 tensor on ``device``, equal
        bit for bit, advancing ``state`` as it does; nothing is read
        back.  Each of the 5n LCG states is the jump-ahead map of its
        offset (:func:`_step_maps`) applied to the state, in wrapping
        int64; the draw ``(s >> 16) & 0x7FFF`` takes bits 16..30, which
        the arithmetic shift leaves as the logical one does, and the
        chain i = i * 32767 + draw is the weighted sum of a draw's five
        (mod 2^64 alike).  It is rounded to float64 once, to nearest
        even, as numpy's cast: its high and low 32 bits are exact in
        float64 and their sum rounds once."""
        steps = 5 * n
        a, c, w = _step_maps(steps, torch.device(device))
        s = torch.add(c, a, alpha=_signed(int(self.state)))
        i = (((s >> 16) & _MAX).view(n, 5) * w).sum(1)
        hi = ((i >> 32) & 0xFFFFFFFF).to(torch.float64)
        lo = (i & 0xFFFFFFFF).to(torch.float64)
        ja, jc = _jump(steps)
        self.state = np.uint64((ja * int(self.state) + jc) % _M64)
        return (hi * 4294967296.0 + lo) / float(np.iinfo(np.uint64).max)
