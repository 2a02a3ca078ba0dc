"""Bit-packed boolean patterns: 32 columns per 32-bit word.

Counterpart of ``graphblas_tpu/sparse/bitpack.py``.  Torch has no
unsigned 32-bit arithmetic and no popcount op, so a packed word is an
int32 tensor element holding the same bits as the JAX package's uint32,
and :func:`popcount` is SWAR bit arithmetic.  The device path that needs
popcounts at scale (``bitdot``) uses a CUDA kernel with ``__popc``.
"""

from __future__ import annotations

import numpy as np
import torch

from .container import resolve_device

__all__ = ["pack_rows", "pack_pattern", "popcount", "words_for"]


def words_for(n: int) -> int:
    """Words per packed row of n columns, padded to a multiple of 8."""
    w = (n + 31) // 32
    return ((w + 7) // 8) * 8


def pack_pattern(pattern, device=None) -> torch.Tensor:
    """[m, n] bool -> [m, W] int32 bit patterns on ``device`` (see
    :func:`container.resolve_device`), bit k of word w = column 32*w+k
    (the same bits as the JAX package's uint32 words)."""
    pattern = np.asarray(pattern)
    m, n = pattern.shape
    W = words_for(n)
    padded = np.zeros((m, W * 32), dtype=bool)
    padded[:, :n] = pattern
    bits = padded.reshape(m, W, 32).astype(np.uint32)
    shifts = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    words = (bits * shifts).sum(axis=2, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(resolve_device(device))


def pack_rows(pattern, device=None) -> torch.Tensor:
    """:func:`pack_pattern` under the JAX package's other name."""
    return pack_pattern(pattern, device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of the low 32 bits of an int32 or
    int64 tensor, as int32 (SWAR: pairs, nibbles, bytes, then one
    multiply sums the four byte counts into the top byte)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
