"""Sparse accumulate/mask epilogue: C<M> = accum(C, T) on CsrMatrix.

Counterpart of ``graphblas_tpu/sparse/mask.py``, with the semantics of
the reference's executable specs (``Test/GB_spec_accum.m`` +
``Test/GB_spec_mask.m``).  The reference runs two passes, ``GB_add``
(union merge) then ``GB_mask`` (``GB_accum_mask.c:246-318``); here both
fold into ONE stable sort over C's and T's tuples with the per-lane case
analysis applied vectorized:

  key in mask:  pair -> accum(c,t) (or cast(t) when accum is None);
                T-only -> cast(t); C-only -> c when accumulating, else
                dropped (Z=T has no entry there)
  key outside:  C entry survives unless REPLACE; T is irrelevant

Mask membership is a binary search (``torch.searchsorted``) in the
mask's keys as stored (a CSR's keys ascend in storage order), then the
selection at the slot found.  Struct values of a user-defined type ride
every select leaf by leaf; a valued mask over them raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.ops import BinaryOp
from ..core.types import (Type, cast, tree_where, value_take,
                          zeros_like_typed)
from ..utils import counters
from ..utils.counters import host_read
from ..utils.tree import tree_map
from .container import CsrMatrix
from .esc import _assemble, _bucket, _empty_csr, _in_mask, _mask_keys

__all__ = ["csr_accum_mask", "csr_clear"]


def _key_dtype(m: int, n: int):
    if (m + 1) * n < (1 << 31):
        return torch.int32
    if (m + 1) * n < (1 << 63):
        return torch.int64
    raise NotImplementedError("dimension product exceeds 2^63")


def _live_keys(X: CsrMatrix, n: int, kdt, big: int) -> torch.Tensor:
    live = torch.arange(X.nzmax, device=X.device) < X.nvals
    keys = X.rowids.to(kdt) * n + X.indices.to(kdt)
    return torch.where(live, keys, big)


def _epilogue(ctype: Type, ttype: Type, accum: Optional[BinaryOp],
              replace: bool, scmp: bool, m: int, n: int, kdt, c_keys,
              c_values, t_keys, t_values, m_keys, m_sel):
    dev = c_keys.device
    big = torch.iinfo(kdt).max
    sent = m * n
    keys = torch.cat([c_keys, t_keys])
    E = keys.shape[0]
    nc = c_keys.shape[0]
    tags = torch.cat([torch.zeros(nc, dtype=torch.bool, device=dev),
                      torch.ones(E - nc, dtype=torch.bool, device=dev)])
    va = tree_map(lambda v: torch.cat([v, torch.zeros(
        E - nc, dtype=v.dtype, device=dev)]), c_values)
    vb = tree_map(lambda v: torch.cat([torch.zeros(
        nc, dtype=v.dtype, device=dev), v]), t_values)

    # stable: C lanes precede T lanes of the same key
    ks, perm = torch.sort(keys, stable=True)
    tg, va, vb = tags[perm], value_take(va, perm), value_take(vb, perm)
    head = torch.ones(E, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    nxt_same = torch.zeros(E, dtype=torch.bool, device=dev)
    nxt_same[:-1] = ks[1:] == ks[:-1]
    live = ks < big
    is_pair = head & nxt_same & live
    t_raw = tree_where(is_pair, tree_map(lambda v: torch.cat(
        [v[1:], v[-1:]]), vb), vb)

    def cast_t(v):
        return cast(v, ctype, ttype)

    if m_keys is not None:
        member = _in_mask(m_keys, m_sel, ks) & live
        if scmp:
            member = ~member & live
    else:
        member = live if not scmp else torch.zeros_like(live)

    c_present = is_pair | (~tg & live)
    t_present = is_pair | (tg & live)

    # value inside the mask (Z value)
    if accum is None:
        z_in = cast_t(t_raw)
        keep_in = t_present
    else:
        ca = cast(va, accum.xtype, ctype)
        tb = cast(t_raw, accum.ytype, ttype)
        z_acc = cast(accum(ca, tb), ctype, accum.ztype)
        z_in = tree_where(is_pair, z_acc, tree_where(tg, cast_t(t_raw), va))
        keep_in = c_present | t_present

    # outside the mask: C survives unless REPLACE
    keep_out = c_present & (not replace)
    out_v = tree_where(member, z_in, va)
    keep = head & torch.where(member, keep_in, keep_out)

    r = torch.cumsum(keep, 0) - 1
    nnz = keep.sum()
    tgt = torch.where(keep, r, E + 1)
    out_keys = torch.full((E + 2,), sent, dtype=kdt, device=dev)
    out_keys.scatter_(0, tgt, ks)
    out_vals = tree_map(lambda o, v: o.scatter_(0, tgt, v.to(o.dtype))
                        [:E + 1], zeros_like_typed((E + 2,), ctype, dev),
                        out_v)
    indptr, oj, oi = _assemble(out_keys[:E + 1], sent, m, n)
    return indptr, oj, oi, out_vals, nnz


def csr_clear(C: CsrMatrix) -> CsrMatrix:
    return _empty_csr(C.nrows, C.ncols, C.type, C.device)


@counters.spanned("gb.engines.accum_mask")
def csr_accum_mask(C: CsrMatrix, M: Optional[CsrMatrix], T: CsrMatrix,
                   accum: Optional[BinaryOp],
                   desc: Optional[Descriptor]) -> CsrMatrix:
    """Full sparse epilogue C<M> = accum(C, T); returns a new CsrMatrix
    of C's type (reference ``GB_accum_mask.c`` semantics)."""
    d = desc_of(desc)
    if T.shape != C.shape:
        raise DimensionMismatch(f"T shape {T.shape} != C shape {C.shape}")
    if M is not None and M.shape != C.shape:
        raise DimensionMismatch(
            f"mask shape {M.shape} != output shape {C.shape}")
    if M is None and d.mask_scmp:
        return csr_clear(C) if d.replace else C
    m, n = C.shape
    kdt = _key_dtype(m, n)
    big = torch.iinfo(kdt).max
    c_keys = _live_keys(C, n, kdt, big)
    t_keys = _live_keys(T, n, kdt, big)
    m_keys, m_sel = (_mask_keys(M, n, kdt, d.mask_structure)
                     if M is not None else (None, None))
    indptr, oj, oi, ov, nnzC = _epilogue(
        C.type, T.type, accum, d.replace, d.mask_scmp, m, n, kdt, c_keys,
        C.values, t_keys, T.values, m_keys, m_sel)
    nnz = host_read(nnzC, "accum_nnz")
    E = c_keys.shape[0] + t_keys.shape[0]
    cap = min(_bucket(max(nnz, 8)), E + 1)
    return CsrMatrix(indptr, oj[:cap], oi[:cap],
                     tree_map(lambda v: v[:cap], ov), nnz, m, n, C.type)
