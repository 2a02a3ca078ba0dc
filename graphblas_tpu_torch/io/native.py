"""ctypes bridge to the native C++ tuple library, shared with the JAX
package.

Counterpart of ``graphblas_tpu/io/native.py``.  The C++ sources live in
``native/`` at the repository root (built by ``native/Makefile`` into
``libgbtpu_native.so``); this module loads the same library for the
host-side triplet parser and tuple assembly (radix sort-dedup, pair
sort, symmetrize-dedup).  Each function returns None when the library
hasn't been built, and its caller runs the numpy form, whose results are
identical, only slower (the card's machine builds no native library, so
the port takes the numpy forms there).  This is host-side work, not a
device path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["native_lib", "parse_triplets_native", "sort_dedup_native",
           "sort_pairs_native", "sym_dedup_native"]

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "native", "libgbtpu_native.so")


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (once) the native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.gbtpu_count_triplets.restype = ctypes.c_int64
        lib.gbtpu_count_triplets.argtypes = [ctypes.c_char_p]
        lib.gbtpu_parse_triplets.restype = ctypes.c_int64
        lib.gbtpu_parse_triplets.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.gbtpu_sort_dedup.restype = ctypes.c_int64
        lib.gbtpu_sort_dedup.argtypes = [
            ctypes.POINTER(ctypes.c_int64),   # I (in/out)
            ctypes.POINTER(ctypes.c_int64),   # J (in/out)
            ctypes.POINTER(ctypes.c_double),  # X (in/out)
            ctypes.c_int64,                   # n tuples
            ctypes.c_int,                     # dup mode: 0=plus 1=first 2=lor
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def parse_triplets_native(path: str):
    """Parse an "i j [x]" triplet file with the C parser: (I, J, X), or
    None if the library is unavailable.

    Malformed input (a non-numeric token, or inconsistent column counts)
    raises ValueError — the same conditions ``np.loadtxt`` raises on in
    the numpy form, so behavior is identical either way.  Values are
    parsed with strtod, so rounding and nan/inf agree with numpy to the
    ULP.
    """
    lib = native_lib()
    if lib is None:
        return None
    n = lib.gbtpu_count_triplets(path.encode())
    if n < 0:
        return None
    I = np.empty(n, dtype=np.int64)
    J = np.empty(n, dtype=np.int64)
    X = np.empty(n, dtype=np.float64)
    got = lib.gbtpu_parse_triplets(
        path.encode(),
        I.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        J.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n)
    if got == -2:
        raise ValueError(
            f"malformed triplet file {path!r}: non-numeric token or "
            f"inconsistent column count")
    if got < 0:
        return None
    return I[:got], J[:got], X[:got]


_DUP_MODES = {"PLUS": 0, "FIRST": 1, "LOR": 2, "SECOND": 3,
              "MIN": 4, "MAX": 5, "TIMES": 6}


def sort_dedup_native(I: np.ndarray, J: np.ndarray, X: np.ndarray,
                      dup_name: str
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]:
    """Sort (i,j)-lexicographic + fold duplicates in input order with the
    named dup operator, in C.  Returns None if unsupported/unavailable."""
    lib = native_lib()
    mode = _DUP_MODES.get(dup_name)
    if lib is None or mode is None or I.size == 0:
        return None
    I = np.ascontiguousarray(I, dtype=np.int64).copy()
    J = np.ascontiguousarray(J, dtype=np.int64).copy()
    X = np.ascontiguousarray(X, dtype=np.float64).copy()
    n = lib.gbtpu_sort_dedup(
        I.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        J.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        I.size, mode)
    if n < 0:
        return None
    return I[:n], J[:n], X[:n]


def sort_pairs_native(I: np.ndarray, J: np.ndarray, nrows: int,
                      ncols: int):
    """Parallel radix (i, j) pair sort.  Returns (I_sorted, J_sorted,
    perm) or None when the library / key range is unavailable.  Stable,
    ascending — bit-identical to ``np.lexsort((J, I))`` ordering."""
    lib = native_lib()
    if lib is None or len(I) == 0:
        return None
    fn = getattr(lib, "gbtpu_sort_pairs", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_int
    Ic = np.ascontiguousarray(I, np.int64).copy()
    Jc = np.ascontiguousarray(J, np.int64).copy()
    perm = np.empty(len(I), np.int64)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = fn(p(Ic), p(Jc), ctypes.c_int64(len(Ic)),
            ctypes.c_int64(nrows), ctypes.c_int64(ncols), p(perm))
    if rc != 0:
        return None
    return Ic, Jc, perm


def sym_dedup_native(I: np.ndarray, J: np.ndarray, n: int):
    """Symmetrize + self-loop removal + dedup of an edge pattern —
    exactly ``np.unique(np.concatenate([I*n+J, J*n+I]))`` minus the
    diagonal (``models.rmat.symmetrize_pattern``'s numpy form),
    parallel.  Returns (I, J) or None."""
    lib = native_lib()
    if lib is None or len(I) == 0:
        return None
    fn = getattr(lib, "gbtpu_sym_dedup_pattern", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_int64
    ne = len(I)
    Ib = np.empty(2 * ne, np.int64)
    Jb = np.empty(2 * ne, np.int64)
    Ib[:ne] = I
    Jb[:ne] = J
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    out = fn(p(Ib), p(Jb), ctypes.c_int64(ne), ctypes.c_int64(n))
    if out < 0:
        return None
    return Ib[:out].copy(), Jb[:out].copy()
