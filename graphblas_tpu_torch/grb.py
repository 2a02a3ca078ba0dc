"""GrB_* / GxB_* compatibility facade.

Counterpart of ``graphblas_tpu/grb.py``: every name of the JAX facade,
over the port's containers.  The reference's public surface is 309 C
functions plus ``_Generic`` polymorphic macros
(``Include/GraphBLAS.h``).  The port's native API
is Pythonic (:mod:`graphblas_tpu_torch`), but this module exposes the
C-style names 1:1 so code written against the reference's API maps
mechanically::

    from graphblas_tpu_torch import grb
    C = grb.GrB_Matrix_new(grb.GrB_FP64, 4, 4)
    C = grb.GrB_mxm(C, None, None, grb.GxB_PLUS_TIMES_FP64, A, B, None)

Functional-style note: operations RETURN the output object instead of
mutating the first argument (GrB_Info error codes become exceptions).
Polymorphic _Generic macros (GrB_assign, GrB_reduce, GxB_set/get, ...)
dispatch on Python types exactly as the C macros dispatch on C types.
The constructors make their containers on the card unless ``device``
says otherwise; ``GrB_*_build`` keeps the device of its output.

Per-object options (``GxB_Matrix_Option_set``, ``GxB_set`` on a
container) live in the container's ``_options`` beside the engines'
caches; a field that names a cache (:func:`core.options.is_cache_key`)
is refused, and the options carry over to the containers that
``setElement``/``wait`` derive from it.
"""

from __future__ import annotations

import numpy as np

from . import (Matrix, Vector, mxm, mxv, vxm, eWiseAdd, eWiseMult, apply,
               select, reduce, transpose, kron, extract, extract_vector,
               extract_col, assign, subassign, assign_scalar,
               subassign_scalar, assign_vector, subassign_vector,
               row_assign, col_assign, import_csr, import_csc,
               import_hyper_csr, export_csr, export_hyper_csr, export_csc,
               import_vector, export_vector, fprint, init as _init,
               set_option, get_option, Descriptor)
from .core import types as _t
from .core.monoids import MONOIDS, monoid_new
from .core.ops import (BinaryOp, SelectOp, UnaryOp, binary,
                       select as _selectops, unary)
from .core.semirings import SEMIRINGS, semiring_new
from .core.errors import Info, InvalidValue
from .core.options import is_cache_key
from .utils.indices import ALL as GrB_ALL

__all__ = ["GrB_ALL"]  # extended programmatically below

# -- types --------------------------------------------------------------------
GrB_BOOL = _t.BOOL
GrB_INT8 = _t.INT8
GrB_UINT8 = _t.UINT8
GrB_INT16 = _t.INT16
GrB_UINT16 = _t.UINT16
GrB_INT32 = _t.INT32
GrB_UINT32 = _t.UINT32
GrB_INT64 = _t.INT64
GrB_UINT64 = _t.UINT64
GrB_FP32 = _t.FP32
GrB_FP64 = _t.FP64
GxB_FC32 = _t.FC32
GxB_FC64 = _t.FC64


def GrB_Type_new(size_or_fields) -> _t.Type:
    """User type: pass a dict of field name -> Type (struct-of-arrays)."""
    if isinstance(size_or_fields, dict):
        return _t.Type.udt("user_type", **size_or_fields)
    raise TypeError("pass {field: Type} — opaque byte sizes have no "
                    "tensor representation")


# -- init / finalize / error ------------------------------------------------
GrB_BLOCKING = "blocking"
GrB_NONBLOCKING = "nonblocking"


def GrB_init(mode=GrB_NONBLOCKING):
    _init(mode)
    return Info.SUCCESS


def GxB_init(mode=GrB_NONBLOCKING, *malloc_vtable):
    # custom allocators are PyTorch's concern; accepted for parity
    return GrB_init(mode)


def GrB_finalize():
    return Info.SUCCESS


def GrB_error() -> str:
    """Message of the most recent GraphBLAS error on this thread
    (reference semantics: TLS error string, ``GrB_error.c``).  Errors
    also surface as exceptions; this reports the last one caught."""
    from .core.errors import last_error_message
    return last_error_message()


def GrB_wait(*objs):
    """Force completion of pending work (``GrB_wait()``).  One object
    returns the waited object, several return a tuple; the no-arg
    global-queue form is a no-op because objects own their deltas."""
    if not objs:
        return Info.SUCCESS
    waited = tuple(o.wait() for o in objs)
    return waited[0] if len(waited) == 1 else waited


# -- object constructors ------------------------------------------------------
def GrB_Matrix_new(t, nrows, ncols, device=None):
    return Matrix.new(t, nrows, ncols, device=device)


def GrB_Vector_new(t, n, device=None):
    return Vector.new(t, n, device=device)


def GrB_Matrix_dup(A):
    return A.dup()


def GrB_Vector_dup(v):
    return v.dup()


def GrB_Matrix_clear(A):
    return A.clear()


def GrB_Vector_clear(v):
    return v.clear()


def GrB_Matrix_nrows(A):
    return A.nrows


def GrB_Matrix_ncols(A):
    return A.ncols


def GrB_Matrix_nvals(A):
    return A.nvals()


def GrB_Vector_size(v):
    return v.size


def GrB_Vector_nvals(v):
    return v.nvals()


def GxB_Matrix_resize(A, nrows, ncols):
    return A.resize(nrows, ncols)


def GxB_Vector_resize(v, n):
    return v.resize(n)


def GrB_free(obj):
    return Info.SUCCESS  # garbage collected


# -- build / element access ---------------------------------------------------
def GrB_Matrix_build(C, I, J, X, nvals=None, dup=None):
    n = nvals if nvals is not None else len(np.asarray(I))
    I = np.asarray(I)[:n]
    J = np.asarray(J)[:n]
    X = np.asarray(X)[:n]
    return Matrix.from_coo(I, J, X, C.nrows, C.ncols, type=C.type, dup=dup,
                           device=C.device)


def GrB_Vector_build(w, I, X, nvals=None, dup=None):
    n = nvals if nvals is not None else len(np.asarray(I))
    return Vector.from_coo(np.asarray(I)[:n], np.asarray(X)[:n], w.size,
                           type=w.type, dup=dup, device=w.device)


def GrB_Matrix_setElement(C, x, i, j):
    return C.setElement(x, i, j)


def GrB_Vector_setElement(w, x, i):
    return w.setElement(x, i)


def GrB_Matrix_extractElement(A, i, j):
    return A.extractElement(i, j)


def GrB_Vector_extractElement(v, i):
    return v.extractElement(i)


def GrB_Matrix_extractTuples(A):
    return A.extractTuples()


def GrB_Vector_extractTuples(v):
    return v.extractTuples()


def GxB_Matrix_removeElement(A, i, j):
    return A.removeElement(i, j)


# -- operations (polymorphic like the _Generic macros) -----------------------
GrB_mxm = mxm
GrB_mxv = mxv
GrB_vxm = vxm
GrB_transpose = transpose
GxB_kron = kron
GrB_reduce = reduce
GxB_select = select
GrB_apply = apply


def GrB_eWiseAdd(C, M, accum, op, A, B, desc=None):
    return eWiseAdd(C, M, accum, op, A, B, desc)


def GrB_eWiseMult(C, M, accum, op, A, B, desc=None):
    return eWiseMult(C, M, accum, op, A, B, desc)


def GrB_extract(C, M, accum, A, I=None, J=None, desc=None):
    """Polymorphic GrB_extract (matrix / vector / column)."""
    if isinstance(C, Vector):
        if isinstance(A, Vector):
            return extract_vector(C, M, accum, A, I, desc)
        return extract_col(C, M, accum, A, I, 0 if J is None else J, desc)
    return extract(C, M, accum, A, I, J, desc)


GrB_Col_extract = extract_col


def GrB_assign(C, M, accum, A, I=None, J=None, desc=None):
    """Polymorphic GrB_assign (matrix/vector/row/col/scalar forms)."""
    if isinstance(C, Vector):
        if isinstance(A, Vector):
            return assign_vector(C, M, accum, A, I, desc)
        return assign_vector(C, M, accum, A, I, desc, scalar=True)
    if isinstance(A, Matrix):
        return assign(C, M, accum, A, I, J, desc)
    if isinstance(A, Vector):
        if isinstance(I, (int, np.integer)):
            return row_assign(C, M, accum, A, I, J, desc)
        return col_assign(C, M, accum, A, I, 0 if J is None else J, desc)
    return assign_scalar(C, M, accum, A, I, J, desc)


def GxB_subassign(C, M, accum, A, I=None, J=None, desc=None):
    if isinstance(C, Vector):
        if isinstance(A, Vector):
            return subassign_vector(C, M, accum, A, I, desc)
        return subassign_vector(C, M, accum, A, I, desc, scalar=True)
    if isinstance(A, Matrix):
        return subassign(C, M, accum, A, I, J, desc)
    if isinstance(A, Vector):
        # GxB_Row/Col_subassign: lift the vector to a 1-column (or
        # 1-row) submatrix
        from .ops.assign import _as_matrix
        if isinstance(I, (int, np.integer)):       # row form: C(i,J) = u'
            return subassign(C, _as_matrix(M, col=False) if M is not None
                             else None, accum, _as_matrix(A, col=False),
                             [I], J, desc)
        return subassign(C, _as_matrix(M) if M is not None else None,
                         accum, _as_matrix(A), I,
                         [0 if J is None else J], desc)
    return subassign_scalar(C, M, accum, A, I, J, desc)


GrB_Row_assign = row_assign
GrB_Col_assign = col_assign

# -- import / export ----------------------------------------------------------
GxB_Matrix_import_CSR = import_csr
GxB_Matrix_import_CSC = import_csc
GxB_Matrix_import_HyperCSR = import_hyper_csr
GxB_Matrix_export_HyperCSR = export_hyper_csr
GxB_Matrix_export_CSR = export_csr
GxB_Matrix_export_CSC = export_csc
GxB_Vector_import = import_vector
GxB_Vector_export = export_vector

# -- print / check ------------------------------------------------------------
GxB_Matrix_fprint = fprint
GxB_Vector_fprint = fprint
GxB_Type_fprint = fprint
GxB_UnaryOp_fprint = fprint
GxB_BinaryOp_fprint = fprint
GxB_Monoid_fprint = fprint
GxB_Semiring_fprint = fprint
GxB_Descriptor_fprint = fprint
GxB_SelectOp_fprint = fprint

# -- operator constructors ----------------------------------------------------
def GrB_UnaryOp_new(fn, ztype, xtype, name="user_unary"):
    return UnaryOp(name.upper(), fn, ztype, xtype)


def GrB_BinaryOp_new(fn, ztype, xtype, ytype, name="user_binary"):
    return BinaryOp(name.upper(), fn, ztype, xtype, ytype)


def GrB_Monoid_new(op, identity):
    return monoid_new(op, identity)


def GxB_Monoid_terminal_new(op, identity, terminal):
    return monoid_new(op, identity, terminal)


def GrB_Semiring_new(add, mult):
    return semiring_new(add, mult)


def GxB_SelectOp_new(fn, name="user_select"):
    return SelectOp(name.upper(), fn)


# -- descriptors / options ----------------------------------------------------
GrB_OUTP, GrB_MASK, GrB_INP0, GrB_INP1 = "outp", "mask", "inp0", "inp1"
GrB_REPLACE, GrB_SCMP, GrB_TRAN = "replace", "scmp", "tran"
GxB_AxB_METHOD = "axb_method"
GxB_DEFAULT = None
GxB_AxB_GUSTAVSON, GxB_AxB_HEAP, GxB_AxB_DOT = \
    "gustavson", "heap", "dot"


def GrB_Descriptor_new():
    return Descriptor()


_DESC_FIELD = {GrB_OUTP: "replace", GrB_MASK: "mask_scmp",
               GrB_INP0: "tran0", GrB_INP1: "tran1"}


def GrB_Descriptor_set(desc, field, value):
    if field == GxB_AxB_METHOD:
        return desc.with_(axb_method=value)
    attr = _DESC_FIELD.get(field)
    if attr is None:
        raise ValueError(f"unknown descriptor field {field!r}")
    if value is GxB_DEFAULT:
        return desc.with_(**{attr: False})   # reset to the default
    ok = {(GrB_OUTP, GrB_REPLACE), (GrB_MASK, GrB_SCMP),
          (GrB_INP0, GrB_TRAN), (GrB_INP1, GrB_TRAN)}
    if (field, value) not in ok:
        raise ValueError(f"bad descriptor setting {field}={value}")
    return desc.with_(**{attr: True})


def GxB_set(target, field, value=None):
    """Polymorphic GxB_set (the reference's _Generic macro): descriptor
    form, per-matrix/vector option form, or global-option form
    ``GxB_set(field, value)`` (2 args)."""
    if isinstance(target, Descriptor):
        return GrB_Descriptor_set(target, field, value)
    if hasattr(target, "_options"):
        return GxB_Matrix_Option_set(target, field, value)
    set_option(target, field)   # (field, value) global form
    return Info.SUCCESS


def GxB_get(obj, field=None):
    """Polymorphic GxB_get.  Descriptor -> field value; Matrix/Vector ->
    per-object option (falling back to the global scope); a field-name
    string alone -> global option."""
    if isinstance(obj, Descriptor):
        return getattr(obj, {"outp": "replace", "mask": "mask_scmp",
                             "inp0": "tran0", "inp1": "tran1",
                             "axb_method": "axb_method"}[field])
    if hasattr(obj, "_options"):
        return GxB_Matrix_Option_get(obj, field)
    if isinstance(obj, str) and field is None:
        return get_option(obj)
    return get_option(field)


def GxB_Matrix_Option_set(A, field, value):
    """Per-matrix option scope (reference ``GxB_Matrix_Option_set.c``:
    format / hyper ratio live on the object).  Metadata here — bitmap/
    padded-CSR storage has no semantic format switch — but the setting
    sticks to the object, survives wait()/accum, and GxB_get reports it
    in preference to the global scope.  A field that names an engine
    cache is refused (``GrB_INVALID_VALUE``)."""
    f = str(field)
    if is_cache_key(f):
        raise InvalidValue(f"option {f!r} names an engine cache")
    A._options[f] = value
    return Info.SUCCESS


def GxB_Matrix_Option_get(A, field):
    f = str(field)
    if f in A._options and not is_cache_key(f):
        return A._options[f]
    return get_option(f)


GxB_Vector_Option_set = GxB_Matrix_Option_set
GxB_Vector_Option_get = GxB_Matrix_Option_get


def GxB_Global_Option_set(field, value):
    set_option(field, value)
    return Info.SUCCESS


def GxB_Global_Option_get(field):
    return get_option(field)


# -- predefined object catalogs, exported under their GxB names --------------
globals().update(SEMIRINGS)       # 960 GxB_*_*_TYPE semirings
globals().update(MONOIDS)         # 44 GxB_*_MONOID monoids

# named binary/unary ops: GrB_PLUS_FP64 etc.
for _fam in ("first", "second", "min", "max", "plus", "minus", "times",
             "div", "eq", "ne", "gt", "lt", "ge", "le", "lor", "land",
             "lxor", "pair", "rminus", "rdiv", "iseq", "isne", "isgt",
             "islt", "isge", "isle"):
    for _tt in _t.BUILTIN_TYPES:
        try:
            globals()[f"GrB_{_fam.upper()}_{_tt.name}"] = \
                binary[_fam][_tt]
        except (KeyError, AttributeError):
            pass
for _fam in ("identity", "ainv", "minv", "lnot", "one", "abs"):
    for _tt in _t.BUILTIN_TYPES:
        try:
            globals()[f"GrB_{_fam.upper()}_{_tt.name}"] = unary[_fam][_tt]
        except (KeyError, AttributeError):
            pass
GrB_LNOT = unary.lnot[_t.BOOL]
GrB_LOR = binary.lor[_t.BOOL]
GrB_LAND = binary.land[_t.BOOL]
GrB_LXOR = binary.lxor[_t.BOOL]

GxB_TRIL = _selectops.tril
GxB_TRIU = _selectops.triu
GxB_DIAG = _selectops.diag
GxB_OFFDIAG = _selectops.offdiag
GxB_NONZERO = _selectops.nonzero

__all__ = [k for k in globals()
           if k.startswith(("GrB_", "GxB_"))]
