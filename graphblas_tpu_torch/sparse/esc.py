"""Expand-sort-compress masked SpGEMM helpers.

Counterpart of ``graphblas_tpu/sparse/esc.py``.  Only the capacity
bucket is here so far; the ESC engine itself comes with the general
masked SpGEMM slice.
"""

from __future__ import annotations

__all__ = ["_bucket"]


def _bucket(x: int, lo: int = 128) -> int:
    """Round up to the next power of two (>= lo)."""
    c = lo
    while c < x:
        c <<= 1
    return c
