"""Masked semiring matrix multiply: mxm / mxv / vxm.

Counterpart of ``graphblas_tpu/ops/mxm.py``.  Reference call stack
(``SURVEY.md`` 3.1): GrB_mxm -> GB_mxm -> GB_AxB_meta (engine selection)
-> the generated semiring worker -> GB_accum_mask.  The output container
picks the engines.

``mxm`` with a CSR output runs ``_mxm_sparse``: the flop cost model
(``choose_axb_method``) picks the engine.  At small dense scale the
bitmap product ``semiring_mm`` runs and its result converts back to CSR;
otherwise a masked numeric product tries the value-panel engine
(``sparse.valdot``) and everything else, or what it refuses, runs the
ESC engine (``sparse.esc``); the sparse accum/mask epilogue
(``sparse.mask``) finishes.

``mxm`` with a bitmap ``Matrix`` output runs ``semiring_mm`` on the
bitmap operands, or, for a CSR/CSC ``A`` and a bitmap ``B``, the SpMM
fast path (:mod:`graphblas_tpu_torch.sparse.spmm`); the bitmap epilogue
(:mod:`core.mask`) finishes.

``semiring_mm`` has the JAX package's three value paths, chosen by
(add monoid, mult op): one matrix product for the semirings whose
reduction is a dot product (``_mxu_path``; the name is the JAX
package's engine name), the tropical kernel K6 for FP32 MIN_PLUS,
MAX_PLUS, MIN_MAX and MAX_MIN on the card (``_tropical_path``,
:mod:`graphblas_tpu_torch.sparse.cuda_tropical`), and a k-blocked
broadcast-multiply + monoid reduce for any other (``_generic_path``).
Torch has no integer or bool matmul on CUDA, so integer and boolean
products take an exact route: 16-bit limbs multiplied as float64
matmuls (exact below 2^53) and recombined in int64, wrapped to the
output width; float products are ``torch.matmul`` in full precision.
On CPU operands the tropical route bows out, as the JAX package's does
on its CPU backend, and the generic path gives the same output.
Complex products (FC32, FC64) are one ``torch.matmul`` in complex, as
the JAX package's ``jnp.matmul``; a user-defined semiring takes the
generic path over the struct's leaves (``Monoid.reduce`` folds a
struct pairwise, the JAX package's ``_udt_reduce``), and with a CSR or CSC ``A`` it converts to the bitmap
product instead of the SpMM path, as in the JAX package.

``mxv``/``vxm`` (the SpMV slice) take a bitmap ``Vector`` output: a CSR
or CSC ``A`` runs the edge-parallel SpMV engines of
:mod:`graphblas_tpu_torch.sparse.spmv` (the BSR tile kernel, K5, for a
dense f32 ``plus_times`` product on dense-enough tiles), a bitmap ``A``
runs ``semiring_mm``; the bitmap epilogue (:mod:`core.mask`) finishes.

A hypersparse output runs the pair-key ESC engine
(:func:`graphblas_tpu_torch.sparse.hyper.hyper_spgemm`, dimension up to
2^60) with the mask pushed into the product, then the hypersparse
epilogue: ``mxm`` into a ``HyperMatrix``, or into a ``HyperCscMatrix``
as C' = B'A' with the multiply flipped on the wrapped by-row container;
``mxv``/``vxm`` into a ``SparseVec`` as a one-column SpGEMM (u'A as
(A'u)' with the multiply flipped).  Other operands convert toward the
output.  An ``mxm`` into a ``CscMatrix`` or ``Vector`` raises
:class:`UnsupportedContainer`, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.descriptor import Descriptor, desc_of
from ..core.errors import DimensionMismatch
from ..core.mask import accum_mask
from ..core.matrix import Matrix, Vector
from ..core.ops import BinaryOp
from ..core.semirings import Semiring
from ..core.types import (BOOL, INT64, Type, cast, cast_result, tree_where,
                          type_of_storage, zeros_like_typed)
from ..utils import counters
from ..utils.tree import tree_map
from .containers import (UnsupportedContainer, require_container,
                         to_bitmap_operand, to_csr_operand, to_hyper_operand,
                         vec_hyper_operand)
from .flopcount import choose_axb_method, csr_flopcount, record_axb_method

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
    if out.is_complex:
        acc = out.storage
    else:
        acc = torch.float64 if out.name == "FP64" else torch.float32
    # the product must be full float32, as the JAX package's HIGHEST; the
    # caller's TF32 setting is restored after it
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.to(acc), b.to(acc)).to(out.storage)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


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
    if zt.is_udt or xt.is_udt or yt.is_udt:
        return None

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


#: mults for which an absent entry filled with the add identity gives
#: the identity or NaN (which the kernel's fmin/fmax ignore): not TIMES,
#: where 0 * inf is NaN but -1 * inf flips the identity's sign
_TROPICAL_SAFE_MULTS = ("PLUS", "MIN", "MAX")


def _tropical_path(sr: Semiring, Av, Ap, Bv, Bp, at: Type, bt: Type):
    """(values, method) through the tropical kernel K6 for FP32
    MIN/MAX-monoid semirings over PLUS, MIN or MAX on CUDA operands;
    None otherwise (CPU operands take the generic path, as the JAX
    package's CPU backend does)."""
    from ..sparse.cuda_tropical import TROPICAL_PAIRS
    add, mult = sr.add.op.name, sr.mult.name
    zt = sr.ztype
    if (zt.is_udt or (add, mult) not in TROPICAL_PAIRS
            or mult not in _TROPICAL_SAFE_MULTS or zt.name != "FP32"):
        return None
    if Ap.device.type == "cpu":
        return None
    return _tropical_values(sr, Av, Ap, Bv, Bp, at, bt)


def _tropical_values(sr: Semiring, Av, Ap, Bv, Bp, at: Type, bt: Type):
    """The route's product: absent entries filled with the add identity,
    then ``tropical_mm`` (the kernel on CUDA, its plain version on the
    CPU); returns (values, method)."""
    from ..sparse.cuda_tropical import tropical_mm
    add, mult = sr.add.op.name, sr.mult.name
    zt = sr.ztype
    ident = float(sr.add.identity)
    a = torch.where(Ap, cast(Av, zt, at), ident)
    b = torch.where(Bp, cast(Bv, zt, bt), ident)
    out = tropical_mm(a, b, add, mult)
    route = "cuda" if out.is_cuda else "torch"
    return out, f"{route}:tropical_{add.lower()}_{mult.lower()}"


def _generic_path(sr: Semiring, Av, Ap, Bv, Bp, at: Type, bt: Type):
    """Any (monoid, mult): k blocks of broadcast multiply [m, kc, n],
    absent pairs set to the add identity, monoid-reduced over kc and
    folded into the carry (every leaf of a struct value alike)."""
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
        z = sr.mult(tree_map(lambda a: a[:, s:s + kc, None], Av),
                    tree_map(lambda b: b[None, s:s + kc, :], Bv))
        z = tree_where(pair, cast_result(z, zt), ident)
        out = cast_result(sr.add(out, sr.add.reduce(z, axis=1)), zt)
    return out, "vpu:generic"


def semiring_mm(sr: Semiring, Av, Ap, Bv, Bp, method_hint=None,
                atype: Optional[Type] = None, btype: Optional[Type] = None):
    """T = A *.semiring* B on (values, pattern) pairs.

    Returns (Tvals, Tpat, method_used); ``method_used`` is the
    reference's ``AxB_method_used`` (``GB_matrix.h:351``).
    ``method_hint``: 'gustavson'/'heap' force the generic path.
    FP32 tropical semirings on CUDA operands take the kernel K6.
    ``atype``/``btype``: the value types (default: the types the storage
    dtypes name, signed)."""
    if Ap.shape[1] != Bp.shape[0]:
        raise DimensionMismatch(f"inner dims {tuple(Ap.shape)} x "
                                f"{tuple(Bp.shape)}")
    atype = atype or type_of_storage(Av.dtype)
    btype = btype or type_of_storage(Bv.dtype)
    dev = Ap.device
    tpat = _pattern_mm(Ap, Bp)
    fast = None
    if method_hint not in ("gustavson", "heap"):
        fast = (_mxu_path(sr, Av, Ap, Bv, Bp, atype, btype)
                or _tropical_path(sr, Av, Ap, Bv, Bp, atype, btype))
    if fast is not None:
        vals, method = fast
    else:
        vals, method = _generic_path(sr, Av, Ap, Bv, Bp, atype, btype)
    record_axb_method(method)
    zt = sr.ztype
    vals = tree_where(tpat, cast_result(vals, zt),
                      zeros_like_typed((), zt, dev))
    return vals, tpat, method


def _mxm_sparse(C, M, accum, sr: Semiring, A, B, d: Descriptor):
    """Sparse-output mxm: engine chosen by the cost model (the
    GB_AxB_meta auto-select), then the CSR epilogue."""
    from ..sparse.container import CsrMatrix
    from ..sparse.esc import csr_spgemm
    from ..sparse.mask import csr_accum_mask
    from ..sparse.valdot import valdot_masked_spgemm
    C = C.wait()
    A = to_csr_operand(A, what="mxm input A")
    B = to_csr_operand(B, what="mxm input B")
    Mc = to_csr_operand(M, what="mxm mask") if M is not None else None
    if d.tran0:
        A = A.T()
    if d.tran1:
        B = B.T()
    m, k = A.shape
    n = B.ncols
    if B.nrows != k:
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if C.shape != (m, n):
        raise DimensionMismatch(f"C is {C.shape}, product is {(m, n)}")
    # exact flop count when the build-time host patterns are around
    # (the JAX package's gate), made on the device from the CSR arrays;
    # else the estimate
    with counters.span("gb.planning.flopcount"):
        if (A._options.get("host_pattern") is not None
                and B._options.get("host_pattern") is not None):
            est_flops = max(1, csr_flopcount(A, B))
        else:
            est_flops = max(1, (A.nvals * B.nvals) // max(k, 1))
    with counters.span("gb.planning.choose"):
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


def _mxm_spmm(C: Matrix, M, accum, sr: Semiring, A, B: Matrix,
              d: Descriptor):
    """The SpMM fast path: CSR/CSC ``A`` times a bitmap ``B`` into a
    bitmap ``C``, one k-wide row gather per entry of A.  Whether B is
    all present is read from its pattern on every call."""
    from ..sparse.spmm import csr_spmm_dense
    Ac = to_csr_operand(A, tran=d.tran0, what="mxm input A")
    B = B.wait()
    Bv, Bp = _oriented(B, d.tran1)
    if Ac.ncols != Bv.shape[0]:
        raise DimensionMismatch(f"A is {Ac.shape}, B is {tuple(Bv.shape)}")
    allp = bool(Bp.all())
    tvals, tpat = csr_spmm_dense(sr, Ac, Bv, None if allp else Bp,
                                 x_type=B.type)
    T = Matrix(tvals, tpat, sr.ztype)
    M = to_bitmap_operand(M, "mxm mask") if M is not None else None
    return accum_mask(C, M, T, accum, d)


def _mxm_bitmap(C: Matrix, M, accum, sr: Semiring, A, B, d: Descriptor):
    """Bitmap-output mxm: ``semiring_mm`` on the bitmap operands, then
    the bitmap epilogue."""
    A = to_bitmap_operand(A, "mxm input A")
    B = to_bitmap_operand(B, "mxm input B")
    M = to_bitmap_operand(M, "mxm mask") if M is not None else None
    Av, Ap = _oriented(A, d.tran0)
    Bv, Bp = _oriented(B, d.tran1)
    tvals, tpat, _ = semiring_mm(sr, Av, Ap, Bv, Bp,
                                 method_hint=d.axb_method, atype=A.type,
                                 btype=B.type)
    return accum_mask(C, M, Matrix(tvals, tpat, sr.ztype), accum, d)


def _oriented(X, tran: bool):
    """(values, pattern) of a bitmap container, transposed when asked
    (every leaf of a struct value alike)."""
    if not tran:
        return X.values, X.pattern
    return tree_map(lambda v: v.T, X.values), X.pattern.T


def _mxm_hyper(C, M, accum, sr: Semiring, A, B, d: Descriptor):
    """Hypersparse-output mxm at any dimension: the mask pushed into the
    pair-key ESC product, then the full ``GB_accum_mask`` epilogue
    (skipped when C starts empty and there is no accum, the
    ``GB_transplant_conform`` shortcut of ``GB_mxm.c:141``)."""
    from ..sparse.hyper import hyper_accum_mask, hyper_spgemm
    C = C.wait()
    A = to_hyper_operand(A, d.tran0, "mxm input A")
    B = to_hyper_operand(B, d.tran1, "mxm input B")
    M = to_hyper_operand(M, False, "mask") if M is not None else None
    T = hyper_spgemm(sr, A, B, mask=M, complement=d.mask_scmp,
                     structural=d.mask_structure)
    if accum is None and C.nvals == 0:
        return T
    return hyper_accum_mask(C, M, T, accum, replace=d.replace,
                            complement=d.mask_scmp,
                            structural=d.mask_structure)


def _mxm_hyper_csc(C, M, accum, sr: Semiring, A, B, d: Descriptor):
    """By-column hypersparse output: C' = B'A' with the multiply flipped
    to keep the operand order (the ``GB_AxB_meta.c:86-185`` swap rule)
    on the wrapped by-row container."""
    from ..sparse.hyper import hyper_accum_mask, hyper_spgemm
    from ..sparse.hyper_csc import HyperCscMatrix
    Ct = C.tr.wait()
    Aw = to_hyper_operand(A, not d.tran0, "mxm input A")
    Bw = to_hyper_operand(B, not d.tran1, "mxm input B")
    Mw = to_hyper_operand(M, True, "mask") if M is not None else None
    T = hyper_spgemm(_flipped(sr), Bw, Aw, mask=Mw, complement=d.mask_scmp,
                     structural=d.mask_structure)
    if accum is None and Ct.nvals == 0:
        return HyperCscMatrix(T)
    return HyperCscMatrix(hyper_accum_mask(
        Ct, Mw, T, accum, replace=d.replace, complement=d.mask_scmp,
        structural=d.mask_structure))


def _spmv_hyper(w, m, accum, sr: Semiring, A, u, d: Descriptor, tran: bool):
    """A SparseVec output: w<m> = accum(w, op(A) u) as a one-column
    hypersparse SpGEMM (the vector-is-a-matrix identity)."""
    from ..sparse.hyper import hyper_accum_mask, hyper_spgemm
    from ..sparse.vector import SparseVec
    Ah = to_hyper_operand(A, tran, "input A")
    uh = vec_hyper_operand(u, "input u")
    mh = vec_hyper_operand(m, "mask") if m is not None else None
    T = hyper_spgemm(sr, Ah, uh, mask=mh, complement=d.mask_scmp,
                     structural=d.mask_structure)
    return SparseVec(hyper_accum_mask(
        w.hm, mh, T, accum, replace=d.replace, complement=d.mask_scmp,
        structural=d.mask_structure))


@counters.counted("mxm")
@counters.spanned("gb.entry.mxm")
def mxm(C, M, accum: Optional[BinaryOp], semiring: Semiring, A, B,
        desc: Optional[Descriptor] = None):
    """C<M> = accum(C, A*B) (reference ``GrB_mxm`` -> ``GB_mxm.c``).

    Container dispatch: a CsrMatrix ``C`` takes the sparse-output
    engines (engine choice by the flop cost model,
    ``choose_axb_method``); a bitmap ``Matrix`` ``C`` takes the SpMM fast
    path for a CSR/CSC ``A`` and a bitmap ``B``, and the dense engines
    of ``semiring_mm`` otherwise.  ``semiring`` and ``accum`` may be
    objects or catalog names (``"plus_times"``, typed by the
    operands)."""
    require_container(C, "mxm output C")
    require_container(M, "mxm mask", none_ok=True)
    require_container(A, "mxm input A")
    require_container(B, "mxm input B")
    from ..core.resolve import resolve_accum, resolve_semiring
    semiring = resolve_semiring(semiring, "mxm semiring", None, A, B, C)
    accum = resolve_accum(accum, "mxm accum", None, C, A)
    d = desc_of(desc)
    from ..sparse.container import CscMatrix, CsrMatrix
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(C, HyperCscMatrix):
        return _mxm_hyper_csc(C, M, accum, semiring, A, B, d)
    if isinstance(C, HyperMatrix):
        return _mxm_hyper(C, M, accum, semiring, A, B, d)
    if isinstance(C, CsrMatrix):
        return _mxm_sparse(C, M, accum, semiring, A, B, d)
    if not isinstance(C, Matrix):
        raise UnsupportedContainer(
            f"mxm output C: expected a CsrMatrix, a hypersparse container "
            f"or a bitmap Matrix, got {type(C).__name__}")
    if (isinstance(A, (CsrMatrix, CscMatrix)) and isinstance(B, Matrix)
            and not any(t.is_udt for t in (semiring.ztype, semiring.xtype,
                                           semiring.ytype, A.type,
                                           B.type))):
        return _mxm_spmm(C, M, accum, semiring, A, B, d)
    return _mxm_bitmap(C, M, accum, semiring, A, B, d)


def _vector_args(op: str, w, m, u) -> None:
    """A bitmap Vector output, mask and input (a SparseVec output takes
    the hypersparse route before this check)."""
    if not isinstance(w, Vector):
        raise UnsupportedContainer(
            f"{op} output w: expected a Vector or a SparseVec, got "
            f"{type(w).__name__}")
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


#: builtin multiplies whose operands commute exactly, NaN and signed
#: zeros included (logical results)
_COMMUTING = frozenset({"LAND", "LOR", "LXOR", "EQ", "NE"})


def _flipped(sr: Semiring) -> Semiring:
    """The semiring with its multiply's operands swapped, so that
    (u' A)' = A' (x) u keeps the operand order of non-commutative
    multiplies (FIRST, MINUS, DIV, ...); a logical multiply of one
    domain is its own flip, and keeps its engines' fast paths."""
    mult = sr.mult
    if mult.name in _COMMUTING and mult.xtype is mult.ytype:
        return sr
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
    d = desc_of(desc)
    from ..sparse.vector import SparseVec
    if isinstance(w, SparseVec):
        return _spmv_hyper(w, m, accum, semiring, A, u, d, d.tran0)
    _vector_args("mxv", w, m, u)
    u = u.wait()
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(A, CscMatrix):
        # by-col orientation: A'*u is free (the stored arrays ARE A' in
        # CSR); plain A*u pays one resort
        A, d = ((A.T(), dataclasses.replace(d, tran0=False)) if d.tran0
                else (A.to_csr(), d))
    if isinstance(A, CsrMatrix):
        A = A.wait()
        if d.tran0:
            A = A.T()  # a device sort; large callers should cache A'
        if u.size != A.ncols:
            raise DimensionMismatch(
                f"A is {A.nrows}x{A.ncols}, u has size {u.size}")
        yv, yp = _csr_spmv(semiring, A, u)
        return accum_mask(w, m, Vector(yv, yp, semiring.ztype), accum, d)
    A = to_bitmap_operand(A, "mxv input A")
    Av, Ap = _oriented(A, d.tran0)
    tvals, tpat, _ = semiring_mm(semiring, Av, Ap,
                                 tree_map(lambda v: v[:, None], u.values),
                                 u.pattern[:, None],
                                 method_hint=d.axb_method, atype=A.type,
                                 btype=u.type)
    T = Vector(tree_map(lambda v: v[:, 0], tvals), tpat[:, 0],
               semiring.ztype)
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
    d = desc_of(desc)
    from ..sparse.vector import SparseVec
    if isinstance(w, SparseVec):
        # u'A = (A'u)' with the multiply flipped, as on CSR
        return _spmv_hyper(w, m, accum, _flipped(semiring), A, u, d,
                           not d.tran1)
    _vector_args("vxm", w, m, u)
    u = u.wait()
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(A, CscMatrix):
        # by-col orientation: u'*A runs on the stored arrays (A' in CSR)
        # with no conversion; u'*A' pays the resort instead
        A, d = ((A.to_csr(), d) if d.tran1
                else (A.T(), dataclasses.replace(d, tran1=True)))
    if isinstance(A, CsrMatrix):
        A = A.wait()
        if not d.tran1:
            A = A.T()  # a device sort; large callers should cache A'
        if u.size != A.ncols:
            raise DimensionMismatch(
                f"A' is {A.ncols}x{A.nrows}, u has size {u.size}")
        yv, yp = _csr_spmv(_flipped(semiring), A, u)
        return accum_mask(w, m, Vector(yv, yp, semiring.ztype), accum, d)
    A = to_bitmap_operand(A, "vxm input A")
    Av, Ap = _oriented(A, d.tran1)
    tvals, tpat, _ = semiring_mm(semiring,
                                 tree_map(lambda v: v[None, :], u.values),
                                 u.pattern[None, :], Av, Ap,
                                 method_hint=d.axb_method, atype=u.type,
                                 btype=A.type)
    T = Vector(tree_map(lambda v: v[0, :], tvals), tpat[0, :],
               semiring.ztype)
    return accum_mask(w, m, T, accum, d)
