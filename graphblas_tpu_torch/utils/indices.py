"""Index-list handling for extract/assign.

Counterpart of ``graphblas_tpu/utils/indices.py`` (a copy: the port
imports nothing of the JAX package).  Reference: ``Source/GB_ijlength.c``
/ ``GB_ijproperties.c`` — index lists may be ``GrB_ALL``, explicit
lists, or the GxB_RANGE / GxB_STRIDE / GxB_BACKWARDS special forms.
Here the Python-native forms are: ``ALL`` (or ``None`` / ``:``), ints,
ranges, slices, and integer arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.errors import IndexOutOfBounds, InvalidValue

__all__ = ["ALL", "is_all", "normalize_indices"]


class _All:
    def __repr__(self):  # pragma: no cover
        return "GrB_ALL"


ALL = _All()


def is_all(I: Any) -> bool:
    """Whether ``I`` is GrB_ALL (``ALL``, ``None`` or ``":"``)."""
    return I is None or isinstance(I, _All) or (isinstance(I, str)
                                                and I == ":")


def normalize_indices(I: Any, n: int, unique: bool = False) -> np.ndarray:
    """Resolve an index spec into a 1-D int64 numpy array.

    ``unique=True`` dedups (keeping sorted order) for scalar assign
    expansion, matching GB_spec_assign's ``I = unique(I)``.
    """
    if is_all(I):
        # every index once, in order: in range and unique already
        return np.arange(n, dtype=np.int64)
    if isinstance(I, (int, np.integer)):
        idx = np.asarray([I], dtype=np.int64)
    elif isinstance(I, slice):
        start = 0 if I.start is None else I.start
        step = 1 if I.step is None else I.step
        if I.stop is None:
            stop = -1 if step < 0 else n
        else:
            stop = I.stop
        idx = np.arange(start, stop, step, dtype=np.int64)
    elif isinstance(I, range):
        idx = np.asarray(list(I), dtype=np.int64)
    else:
        idx = np.asarray(I, dtype=np.int64)
        if idx.ndim != 1:
            raise InvalidValue(
                f"index list must be 1-D, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexOutOfBounds(
            f"index out of range: [{idx.min()}, {idx.max()}] vs dim {n}")
    if unique:
        idx = np.unique(idx)
    return idx
