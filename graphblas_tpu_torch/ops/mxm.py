"""Masked semiring matrix multiply on sparse (CSR) outputs.

Counterpart of ``graphblas_tpu/ops/mxm.py`` for a ``CsrMatrix`` output.
Reference call stack (``SURVEY.md`` 3.1): GrB_mxm -> GB_mxm ->
GB_AxB_meta (engine selection) -> the generated semiring worker ->
GB_accum_mask.

``mxm`` with a CSR output runs ``_mxm_sparse``: the flop cost model
(``choose_axb_method``) picks the engine.  At small dense scale the
bitmap product ``semiring_mm`` runs and its result converts back to CSR;
otherwise a masked numeric product tries the value-panel engine
(``sparse.valdot``) and everything else, or what it refuses, runs the
ESC engine (``sparse.esc``); the sparse accum/mask epilogue
(``sparse.mask``) finishes.

``semiring_mm`` has the JAX package's two value paths, chosen by
(add monoid, mult op): one matrix product for the semirings whose
reduction is a dot product (``_mxu_path``; the name is the JAX
package's engine name), and a k-blocked broadcast-multiply + monoid
reduce for any other (``_generic_path``).  Torch has no integer or bool
matmul on CUDA, so integer and boolean products take an exact route:
16-bit limbs multiplied as float64 matmuls (exact below 2^53) and
recombined in int64, wrapped to the output width; float products are
``torch.matmul`` in full precision.  The
tropical Pallas path of the JAX package is never taken off the TPU; the
generic path gives the same output.

``mxv``/``vxm`` (the SpMV slice) take a bitmap ``Vector`` output: a CSR
or CSC ``A`` runs the edge-parallel SpMV engines of
:mod:`graphblas_tpu_torch.sparse.spmv` (the BSR tile kernel, K5, for a
dense f32 ``plus_times`` product on dense-enough tiles), a bitmap ``A``
runs ``semiring_mm``; the bitmap epilogue (:mod:`core.mask`) finishes.

A bitmap, hypersparse or CSC ``mxm`` output, the SpMM fast path and a
hypersparse ``SparseVec`` output come with later slices; those calls
raise :class:`UnsupportedContainer` naming the slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector
from ..core.ops import BinaryOp
from ..core.semirings import Semiring
from ..core.types import BOOL, INT64, Type, cast, type_of_storage
from ..utils import counters
from .containers import (UnsupportedContainer, require_container,
                         to_bitmap_operand, to_csr_operand)
from .flopcount import choose_axb_method, record_axb_method

__all__ = ["mxm", "mxv", "vxm", "semiring_mm"]

#: max elements of one [m, kc, n] broadcast block of the generic path
_GENERIC_BUDGET = 1 << 23


#: bits per limb of the exact integer product, and the k chunk that
#: keeps every partial sum of 16-bit limb products below 2^53
_LIMB = 16
_KC_EXACT = 1 << 21


def _int_mm(a: torch.Tensor, b: torch.Tensor, bits: int = 64
            ) -> torch.Tensor:
    """Exact integer product a @ b modulo 2^bits (rounded up to whole
    16-bit limbs) as int64; torch has no integer matmul on CUDA.

    Each operand splits into 16-bit limbs, a ≡ sum_i a_i 2^(16 i); every
    limb product sum sum_k a_i[k] b_j[k] is a float64 matmul over k
    chunks of 2^21, exact (all partial sums are integers below 2^53),
    and the limb pairs with i + j below the limb count combine in int64
    with wraparound.  Bool (0/1) operands need one limb, and then the
    result is the exact count."""
    k = a.shape[1]
    nl = 1 if (a.dtype == torch.bool and b.dtype == torch.bool) \
        else max(1, -(-bits // _LIMB))
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    mask = (1 << _LIMB) - 1
    la = [((a >> (_LIMB * i)) & mask).to(torch.float64) for i in range(nl)]
    lb = [((b >> (_LIMB * j)) & mask).to(torch.float64) for j in range(nl)]
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for s in range(0, k, _KC_EXACT):
        e = min(s + _KC_EXACT, k)
        for i in range(nl):
            for j in range(nl - i):
                c = torch.matmul(la[i][:, s:e], lb[j][s:e, :])
                out += c.to(torch.int64) << (_LIMB * (i + j))
    return out


def _pattern_mm(Ap: torch.Tensor, Bp: torch.Tensor) -> torch.Tensor:
    """Boolean pattern product: (Ap @ Bp) > 0, counted exactly."""
    return _int_mm(Ap, Bp) > 0


def _truthy(vals, pat, t: Type):
    if t.is_bool:
        return vals & pat
    return (vals != 0) & pat


def _dot(a: torch.Tensor, b: torch.Tensor, out: Type) -> torch.Tensor:
    """Value matmul with an accumulation type that keeps the semantics:
    integer outputs through the exact limb route (integer PLUS wraps mod
    2^bits, and the product mod 2^bits truncated is congruent), float
    outputs in float32 (float64 for FP64) with TF32 off."""
    if out.is_integer:
        return _int_mm(a, b, out.nbits).to(out.storage)
    acc = torch.float64 if out.name == "FP64" else torch.float32
    # the product must be full float32, as the JAX package's HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a.to(acc), b.to(acc)).to(out.storage)


def _as_num(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Values of type t for a product: unsigned become their int64
    values; others stay as stored."""
    if t.is_unsigned:
        return cast(x, INT64, t)
    return x


def _mxu_path(sr: Semiring, Av, Ap, Bv, Bp, at: Type, bt: Type):
    """(values, method) when this semiring maps onto one product;
    ``at``/``bt`` are the operand value types."""
    add, mult = sr.add.op.name, sr.mult.name
    zt = sr.ztype
    xt, yt = sr.xtype, sr.ytype

    if add == "PLUS" and not zt.is_bool:
        if mult == "TIMES":
            a = _as_num(cast(Av, xt, at), xt)
            b = _as_num(cast(Bv, yt, bt), yt)
            return _dot(a, b, zt), "mxu:plus_times"
        if mult == "FIRST":
            return (_dot(_as_num(cast(Av, zt, at), zt), Bp, zt),
                    "mxu:plus_first")
        if mult == "SECOND":
            return (_dot(Ap, _as_num(cast(Bv, zt, bt), zt), zt),
                    "mxu:plus_second")
        if mult == "PAIR":
            return _dot(Ap, Bp, zt), "mxu:plus_pair"
        if mult == "LAND":
            return (_dot(_truthy(Av, Ap, at), _truthy(Bv, Bp, bt), zt),
                    "mxu:plus_land")

    if zt.is_bool:
        av = _truthy(cast(Av, BOOL, at), Ap, BOOL)
        bv = _truthy(cast(Bv, BOOL, bt), Bp, BOOL)
        if (add, mult) in (("LOR", "LAND"), ("LOR", "TIMES"),
                           ("MAX", "LAND")):
            return _pattern_mm(av, bv), "mxu:lor_land"
        if (add, mult) in (("LAND", "LOR"), ("MIN", "LOR")):
            # AND_k (a|b) over pairs = no pair with (~a & ~b)
            return ~_pattern_mm(Ap & ~av, Bp & ~bv), "mxu:land_lor"
        if (add, mult) in (("LXOR", "LAND"), ("LXOR", "TIMES")):
            return _int_mm(av, bv) % 2 != 0, "mxu:lxor_land"
        if (add, mult) == ("LOR", "FIRST"):
            return _pattern_mm(av, Bp), "mxu:lor_first"
        if (add, mult) == ("LOR", "SECOND"):
            return _pattern_mm(Ap, bv), "mxu:lor_second"
        if (add, mult) == ("LAND", "FIRST"):
            return ~_pattern_mm(Ap & ~av, Bp), "mxu:land_first"
        if (add, mult) == ("LAND", "SECOND"):
            return ~_pattern_mm(Ap, Bp & ~bv), "mxu:land_second"
    return None


def _generic_path(sr: Semiring, Av, Ap, Bv, Bp, at: Type, bt: Type):
    """Any (monoid, mult): k blocks of broadcast multiply [m, kc, n],
    absent pairs set to the add identity, monoid-reduced over kc and
    folded into the carry."""
    m, k = Ap.shape
    n = Bp.shape[1]
    xt, yt, zt = sr.xtype, sr.ytype, sr.ztype
    Av = cast(Av, xt, at)
    Bv = cast(Bv, yt, bt)
    dev = Ap.device
    out = sr.add.identity_array((m, n), dev)
    ident = sr.add.identity_array((), dev)
    kc = max(1, min(k, _GENERIC_BUDGET // max(1, m * n)))
    for s in range(0, k, kc):
        pair = Ap[:, s:s + kc, None] & Bp[None, s:s + kc, :]
        z = sr.mult(Av[:, s:s + kc, None], Bv[None, s:s + kc, :])
        z = torch.where(pair, z.to(zt.storage), ident)
        out = sr.add(out, sr.add.reduce(z, axis=1)).to(zt.storage)
    return out, "vpu:generic"


def semiring_mm(sr: Semiring, Av, Ap, Bv, Bp, method_hint=None,
                atype: Optional[Type] = None, btype: Optional[Type] = None):
    """T = A *.semiring* B on (values, pattern) pairs.

    Returns (Tvals, Tpat, method_used); ``method_used`` is the
    reference's ``AxB_method_used`` (``GB_matrix.h:351``).
    ``method_hint``: 'gustavson'/'heap' force the generic path.
    ``atype``/``btype``: the value types (default: the types the storage
    dtypes name, signed)."""
    if Ap.shape[1] != Bp.shape[0]:
        raise DimensionMismatch(f"inner dims {tuple(Ap.shape)} x "
                                f"{tuple(Bp.shape)}")
    atype = atype or type_of_storage(Av.dtype)
    btype = btype or type_of_storage(Bv.dtype)
    tpat = _pattern_mm(Ap, Bp)
    fast = (None if method_hint in ("gustavson", "heap")
            else _mxu_path(sr, Av, Ap, Bv, Bp, atype, btype))
    if fast is not None:
        vals, method = fast
    else:
        vals, method = _generic_path(sr, Av, Ap, Bv, Bp, atype, btype)
    record_axb_method(method)
    zt = sr.ztype
    vals = torch.where(tpat, vals.to(zt.storage),
                       torch.zeros((), dtype=zt.storage, device=tpat.device))
    return vals, tpat, method


def _mxm_sparse(C, M, accum, sr: Semiring, A, B, d: Descriptor):
    """Sparse-output mxm: engine chosen by the cost model (the
    GB_AxB_meta auto-select), then the CSR epilogue."""
    from ..sparse.container import CsrMatrix
    from ..sparse.esc import csr_spgemm
    from ..sparse.mask import csr_accum_mask
    from ..sparse.valdot import valdot_masked_spgemm
    A = to_csr_operand(A, what="mxm input A")
    B = to_csr_operand(B, what="mxm input B")
    Mc = to_csr_operand(M, what="mxm mask") if M is not None else None
    if d.tran0:
        A = A.T()
    if d.tran1:
        B = B.T()
    m, k = A.shape
    n = B.ncols
    if C.shape != (m, n):
        raise DimensionMismatch(f"C is {C.shape}, product is {(m, n)}")
    # exact flop count when the build-time host patterns are around
    # (GB_AxB_flopcount.c)
    hpA = A._options.get("host_pattern")
    hpB = B._options.get("host_pattern")
    if hpA is not None and hpB is not None:
        degB = np.bincount(hpB[0][:B.nvals], minlength=k + 1)
        est_flops = max(1, int(degB[hpA[1][:A.nvals]].sum()))
    else:
        est_flops = max(1, (A.nvals * B.nvals) // max(k, 1))
    engine = choose_axb_method(
        m, k, n, A.nvals, B.nvals,
        mnnz=Mc.nvals if Mc is not None else None, est_flops=est_flops)
    counters.add_flops(est_flops)
    if d.axb_method in ("gustavson", "heap"):
        engine = "esc"
    elif d.axb_method == "dot" and engine != "esc":
        engine = "dense-mxu"
    if engine != "esc" and max(m * k, k * n, m * n) <= (1 << 24):
        # dense engines win at small/dense scale: bitmap product, then
        # back to CSR for the sparse epilogue
        Ad, Bd = A.to_matrix(), B.to_matrix()
        tvals, tpat, _ = semiring_mm(sr, Ad.values, Ad.pattern,
                                     Bd.values, Bd.pattern,
                                     method_hint=d.axb_method,
                                     atype=A.type, btype=B.type)
        T = CsrMatrix.from_matrix(Matrix(tvals, tpat, sr.ztype))
    else:
        T = None
        if (Mc is not None and not d.mask_scmp
                and d.axb_method in (None, "dot")):
            # value-panel engine for heavy masked numeric products;
            # refuses (-> None) when it cannot pay
            T = valdot_masked_spgemm(sr, A, B, Mc,
                                     structural=d.mask_structure)
        if T is None:
            # mask pushdown: T is only read where the effective mask
            # selects, so the product skips masked-out flops
            T = csr_spgemm(sr, A, B, mask=Mc, complement=d.mask_scmp,
                           structural=d.mask_structure)
    return csr_accum_mask(C, Mc, T, accum, d)


@counters.counted("mxm")
def mxm(C, M, accum: Optional[BinaryOp], semiring: Semiring, A, B,
        desc: Optional[Descriptor] = None):
    """C<M> = accum(C, A*B) (reference ``GrB_mxm`` -> ``GB_mxm.c``) for a
    CsrMatrix ``C``: the sparse-output engines, engine choice by the
    flop cost model (``choose_axb_method``).  ``semiring`` and ``accum``
    may be objects or catalog names (``"plus_times"``, typed by the
    operands)."""
    require_container(C, "mxm output C")
    require_container(M, "mxm mask", none_ok=True)
    require_container(A, "mxm input A")
    require_container(B, "mxm input B")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "mxm semiring", None, A, B, C)
    accum = resolve_accum(accum, "mxm accum", None, C, A)
    d = desc_of(desc)
    from ..sparse.container import CsrMatrix
    if not isinstance(C, CsrMatrix):
        raise UnsupportedContainer(
            "mxm output C: a bitmap Matrix output (the dense engines and "
            "the SpMM fast path) comes with a later slice of the port "
            "(ROADMAP.md queue 1); pass a CsrMatrix C")
    return _mxm_sparse(C, M, accum, semiring, A, B, d)


def _vector_args(op: str, w, m, u) -> None:
    """The SpMV slice's containers: a bitmap Vector output, mask and
    input."""
    if not isinstance(w, Vector):
        raise UnsupportedContainer(
            f"{op} output w: a hypersparse SparseVec output (the product "
            f"as a 1-column hypersparse SpGEMM) comes with the hypersparse "
            f"slice of the port (ROADMAP.md queue 1, item 10); pass a "
            f"Vector, got {type(w).__name__}")
    for what, x in (("mask", m), ("input u", u)):
        if x is not None and not isinstance(x, Vector):
            raise UnsupportedContainer(f"{op} {what}: expected a Vector, "
                                       f"got {type(x).__name__}")


def _csr_spmv(sr: Semiring, A, u: Vector):
    """csr_mxv on u's values, with no pattern when every entry of u is
    present (the dense-x engines) and u's pattern otherwise.  (The JAX
    package's ``mxv`` always passes the pattern, so it never reaches
    the dense-x engines; their output is the sparse-x engine's.)"""
    from ..sparse.spmv import csr_mxv
    xp = None if u.all_present() else u.pattern
    return csr_mxv(sr, A, u.values, xp, x_type=u.type)


def _flipped(sr: Semiring) -> Semiring:
    """The semiring with its multiply's operands swapped, so that
    (u' A)' = A' (x) u keeps the operand order of non-commutative
    multiplies (FIRST, MINUS, DIV, ...)."""
    mult = sr.mult
    return Semiring(sr.add, BinaryOp(mult.name + "_FLIP",
                                     lambda x, y: mult.fn(y, x),
                                     mult.ztype, mult.ytype, mult.xtype))


@counters.counted("mxv")
def mxv(w, m, accum: Optional[BinaryOp], semiring: Semiring, A, u,
        desc: Optional[Descriptor] = None):
    """w<m> = accum(w, A*u) (reference ``GrB_mxv``).  A CsrMatrix (or
    CscMatrix) ``A`` runs the edge-parallel SpMV engines; a bitmap
    Matrix ``A`` runs ``semiring_mm``.  ``semiring`` and ``accum`` may
    be objects or catalog names, typed by the operands."""
    require_container(w, "mxv output w")
    require_container(m, "mxv mask", none_ok=True)
    require_container(A, "mxv input A")
    require_container(u, "mxv input u")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "mxv semiring", None, A, u, w)
    accum = resolve_accum(accum, "mxv accum", None, w, A)
    _vector_args("mxv", w, m, u)
    from ..sparse.container import CscMatrix, CsrMatrix
    d = desc_of(desc)
    if isinstance(A, CscMatrix):
        # by-col orientation: A'*u is free (the stored arrays ARE A' in
        # CSR); plain A*u pays one resort
        A, d = ((A.T(), dataclasses.replace(d, tran0=False)) if d.tran0
                else (A.to_csr(), d))
    if isinstance(A, CsrMatrix):
        if d.tran0:
            A = A.T()  # host resort; large callers should cache A'
        if u.size != A.ncols:
            raise DimensionMismatch(
                f"A is {A.nrows}x{A.ncols}, u has size {u.size}")
        yv, yp = _csr_spmv(semiring, A, u)
        return accum_mask(w, m, Vector(yv, yp, semiring.ztype), accum, d)
    A = to_bitmap_operand(A, "mxv input A")
    Av, Ap = (A.values.T, A.pattern.T) if d.tran0 else (A.values, A.pattern)
    tvals, tpat, _ = semiring_mm(semiring, Av, Ap, u.values[:, None],
                                 u.pattern[:, None],
                                 method_hint=d.axb_method, atype=A.type,
                                 btype=u.type)
    T = Vector(tvals[:, 0], tpat[:, 0], semiring.ztype)
    return accum_mask(w, m, T, accum, d)


@counters.counted("vxm")
def vxm(w, m, accum: Optional[BinaryOp], semiring: Semiring, u, A,
        desc: Optional[Descriptor] = None):
    """w<m> = accum(w, u'*A) (reference ``GrB_vxm``; INP1 transposes A).
    On CSR the product runs as A' (x) u with the multiply flipped; a
    CscMatrix ``A`` gives A' with no resort."""
    require_container(w, "vxm output w")
    require_container(m, "vxm mask", none_ok=True)
    require_container(u, "vxm input u")
    require_container(A, "vxm input A")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "vxm semiring", None, u, A, w)
    accum = resolve_accum(accum, "vxm accum", None, w, A)
    _vector_args("vxm", w, m, u)
    from ..sparse.container import CscMatrix, CsrMatrix
    d = desc_of(desc)
    if isinstance(A, CscMatrix):
        # by-col orientation: u'*A runs on the stored arrays (A' in CSR)
        # with no conversion; u'*A' pays the resort instead
        A, d = ((A.to_csr(), d) if d.tran1
                else (A.T(), dataclasses.replace(d, tran1=True)))
    if isinstance(A, CsrMatrix):
        if not d.tran1:
            A = A.T()  # host resort; large callers should cache A'
        if u.size != A.ncols:
            raise DimensionMismatch(
                f"A' is {A.ncols}x{A.nrows}, u has size {u.size}")
        yv, yp = _csr_spmv(_flipped(semiring), A, u)
        return accum_mask(w, m, Vector(yv, yp, semiring.ztype), accum, d)
    A = to_bitmap_operand(A, "vxm input A")
    Av, Ap = (A.values.T, A.pattern.T) if d.tran1 else (A.values, A.pattern)
    tvals, tpat, _ = semiring_mm(semiring, u.values[None, :],
                                 u.pattern[None, :], Av, Ap,
                                 method_hint=d.axb_method, atype=u.type,
                                 btype=A.type)
    T = Vector(tvals[0, :], tpat[0, :], semiring.ztype)
    return accum_mask(w, m, T, accum, d)
