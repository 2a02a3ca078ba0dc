"""The accumulate/mask epilogue for bitmap outputs: C<M> = accum(C, T).

Counterpart of ``graphblas_tpu/core/mask.py``, with the semantics of the
reference's executable specs ``Test/GB_spec_accum.m`` and
``Test/GB_spec_mask.m``: on the bitmap layout the whole epilogue is a
few elementwise selects over ``values`` and ``pattern``.  It serves the
bitmap ``Matrix`` outputs of ``mxm`` and the ``Vector`` outputs of
``mxv``/``vxm`` alike (the mask's shape must be the output's; the
result is a new container of the output's class and type); the CSR
epilogue is :mod:`graphblas_tpu_torch.sparse.mask`.  Struct values of
a user-defined type take every select leaf by leaf; a mask with struct
values is not valid unless it is structural.
"""

from __future__ import annotations

from typing import Optional

import torch

from .descriptor import Descriptor, desc_of
from .errors import DimensionMismatch
from .ops import BinaryOp
from .types import BOOL, cast, tree_where, zeros_like_typed
from ..utils import counters

__all__ = ["accum_values", "effective_mask", "apply_mask", "accum_mask"]


def _like(C, values, pattern: torch.Tensor, zero=None):
    """A container of C's class and type holding ``values`` where
    ``pattern`` is set and 0 elsewhere (the canonical invariant);
    ``zero``: C's typed zero, where the caller made it."""
    if zero is None:
        zero = zeros_like_typed((), C.type, pattern.device)
    return type(C)(tree_where(pattern, values, zero), pattern, C.type)


def accum_values(C, T, accum: Optional[BinaryOp]):
    """Z = accum(C, T) per GB_spec_accum: returns (zvals, zpat).

    - no accum: Z = T (cast to C's type)
    - accum:    intersection -> accum(c, t); C-only -> c; T-only -> cast(t)
    """
    ct = C.type
    if accum is None:
        return cast(T.values, ct, T.type), T.pattern
    both = C.pattern & T.pattern
    cvals = cast(C.values, accum.xtype, ct)
    tvals = cast(T.values, accum.ytype, T.type)
    z_both = cast(accum(cvals, tvals), ct, accum.ztype)
    t_in_c = cast(T.values, ct, T.type)
    zvals = tree_where(both, z_both, tree_where(C.pattern, C.values, t_in_c))
    return zvals, C.pattern | T.pattern


def effective_mask(M, scmp: bool, structural: bool):
    """Boolean mask array of a mask container (GB_spec_mask: Mask ~= 0,
    restricted to the mask's pattern; explicit zeros count as false)."""
    if M is None:
        return None
    if not structural and M.type.is_udt:
        raise TypeError("a mask with user-defined values is not valid; "
                        "use a structural mask")
    mk = M.pattern if structural else M.pattern & cast(M.values, BOOL,
                                                       M.type)
    return ~mk if scmp else mk


def apply_mask(C, M, zvals, zpat, desc: Descriptor):
    """R = C<M> = Z per GB_spec_mask, with REPLACE / SCMP handling."""
    if M is not None and M.shape != C.shape:
        raise DimensionMismatch(
            f"mask shape {M.shape} != output shape {C.shape}")
    if M is None:
        if desc.mask_scmp:
            # complemented empty mask: C unchanged unless replace clears it
            return C.clear() if desc.replace else C
        return _like(C, zvals, zpat)
    mk = effective_mask(M, desc.mask_scmp, desc.mask_structure)
    zero = None
    if desc.replace:
        # C cleared first: nothing of it survives outside the mask
        zero = zeros_like_typed((), C.type, C.device)
        cvals, cpat = zero, False
    else:
        cvals, cpat = C.values, C.pattern
    return _like(C, tree_where(mk, zvals, cvals),
                 torch.where(mk, zpat, cpat), zero)


@counters.spanned("gb.engines.bitmap_mask")
def accum_mask(C, M, T, accum: Optional[BinaryOp],
               desc: Optional[Descriptor]):
    """Full epilogue C<M> = accum(C, T) (reference ``GB_accum_mask.c``),
    the span ``gb.engines.bitmap_mask``."""
    desc = desc_of(desc)
    C = C.wait()
    if M is not None:
        M = M.wait()
    if T.shape != C.shape:
        raise DimensionMismatch(f"T shape {T.shape} != C shape {C.shape}")
    if M is None and desc.mask_scmp:
        # Z never needs computing (GB_spec_mask: R = C)
        return C.clear() if desc.replace else C
    zvals, zpat = accum_values(C, T, accum)
    return apply_mask(C, M, zvals, zpat, desc)
