"""Portable deterministic PRNG matching the reference demos' generator.

The reference demos seed a POSIX.1-2001 example LCG so that demo outputs
are bit-reproducible across machines (``Demo/Source/simple_rand.c``).  We
reimplement the same recurrence (state' = state*1103515245 + 12345;
output = (state/65536) % 32768) so wathen/random-matrix/MIS inputs can be
regenerated identically for golden-output parity tests.  Vectorized batch
variants produce the same streams fast on the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SimpleRand"]

_A = np.uint64(1103515245)
_C = np.uint64(12345)
_MAX = 32767  # SIMPLE_RAND_MAX


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
