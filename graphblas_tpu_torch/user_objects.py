"""User-defined object examples — the compile-time m4 pipeline analogue.

Counterpart of ``graphblas_tpu/user_objects.py``.  The reference lets
users register compile-time types/ops/monoids/semirings via m4 macros
merged into the build (``User/Example/*.m4`` ->
``Source/all_user_objects.c``; 7 examples listed in
``User/README.txt:14-30``).  Here user objects are plain Python values
whose functions take and return tensors, so "compile-time" and
"run-time" user objects are the same thing.  This module reproduces
each shipped example 1:1 as living documentation + test surface:

  my_complex     (user_def1.m4)  — double-complex type + plus/times
  my_plus_rdiv   (user_def2.m4)  — z = y/x binary op
  my_scale       (user_def3.m4)  — z = 2*x unary op
  my_band        (user_def4.m4)  — band select: lo <= j-i <= hi
  my_pagerank    (my_pagerank.m4) — the PageRank UDT semiring
  my_max         (my_max.m4)     — MAX_FP64 monoid with terminal 1e308
"""

from __future__ import annotations

import numpy as np
import torch

from .core.monoids import monoid_new
from .core.ops import BinaryOp, SelectOp, UnaryOp, binary
from .core.semirings import semiring_new
from .core.types import FC64, FP64

__all__ = ["MyComplex", "my_complex_plus", "my_complex_times",
           "my_complex_plus_monoid", "my_complex_plus_times",
           "my_plus_rdiv", "my_scale", "my_band", "my_max_terminal",
           "pagerank_semiring"]

# -- user_def1.m4: double complex + plus/times + plus monoid + semiring ----
MyComplex = FC64  # native complex dtype; the struct {re, im} UDT form
                  # also works: Type.udt("my_complex", re=FP64, im=FP64)

# the sum part by part on the real view: torch's complex add scales its
# second operand by a complex alpha, which turns 0 + inf*j into nan+inf*j
my_complex_plus = BinaryOp(
    "MY_COMPLEX_PLUS", lambda x, y: torch.view_as_complex(
        torch.view_as_real(x) + torch.view_as_real(y)), FC64, FC64, FC64)
my_complex_times = BinaryOp("MY_COMPLEX_TIMES", lambda x, y: x * y,
                            FC64, FC64, FC64)
my_complex_plus_monoid = monoid_new(my_complex_plus, 0 + 0j)
my_complex_plus_times = semiring_new(my_complex_plus_monoid,
                                     my_complex_times)

# -- user_def2.m4: PLUS_RDIV  z = y/x ------------------------------------
my_plus_rdiv = BinaryOp("MY_PLUS_RDIV", lambda x, y: y / x,
                        FP64, FP64, FP64)

# -- user_def3.m4: scale  z = 2*x ----------------------------------------
my_scale = UnaryOp("MY_SCALE", lambda x: 2.0 * x, FP64, FP64)

# -- user_def4.m4: banded select  lo <= j-i <= hi ------------------------
# thunk is (lo, hi)
my_band = SelectOp("MY_BAND", lambda i, j, x, k:
                   ((j - i) >= k[0]) & ((j - i) <= k[1]))

# -- my_max.m4: MAX_FP64 monoid with terminal ----------------------------
my_max_terminal = monoid_new(binary.max[FP64], -np.inf, terminal=1e308)


def pagerank_semiring():
    """The compile-time PageRank semiring (my_pagerank.m4) — literally
    the same objects the runtime path builds in dpagerank2 (shared
    constructor, so they cannot drift apart)."""
    from .models.pagerank import pagerank_ops
    return pagerank_ops()[3]
