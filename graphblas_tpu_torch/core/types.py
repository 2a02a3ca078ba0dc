"""GraphBLAS builtin type table for the PyTorch port.

Counterpart of ``graphblas_tpu/core/types.py``: the 11 builtin types of
the reference (``Source/GB_ops.c:21-48``).  A type names its GraphBLAS
semantics by a numpy ``dtype`` (what host code and the JAX package
compare against) and its device storage by a ``torch`` dtype.

Unsigned types keep signed torch storage of the same width: on torch,
uint16/32/64 lack ``+``, ``maximum``, ``//``, ``scatter_reduce`` and
matmul, so UINT16/32/64 values live in int16/32/64 tensors holding the
same bits.  Code that compares, divides or takes min/max of UINT values
must apply unsigned semantics itself (:func:`ordered` gives an int64 key
with the unsigned order).  UINT8 follows the same rule for uniformity.
Host scalars (:func:`cast_value`, :func:`zero_of`) are numpy scalars of
the type's own dtype, so a UINT64 value keeps its unsigned meaning until
:meth:`Type.to_storage` puts it in storage form.  User-defined types
(ROADMAP.md queue 1, item 7) and the complex types FC32/FC64 come with a
later slice.

Typecasting follows the reference's C-style semantics as the JAX
package implements them (``Source/GB.h:2900-2960``): float->int
truncates toward zero with NaN -> 0 and saturation at the type's range,
int->int wraps modularly, anything->bool is ``x != 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.tree import tree_map

__all__ = [
    "Type", "BOOL", "INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32",
    "INT64", "UINT64", "FP32", "FP64", "FC32", "FC64", "BUILTIN_TYPES",
    "type_of_dtype", "type_by_name", "type_of_storage", "promote", "cast",
    "cast_value", "zero_of", "cast_result", "ordered", "from_ordered",
    "zeros_like_typed", "full_typed", "tree_where", "value_take",
    "value_shape",
]


def _sub(dtype, kind) -> bool:
    return dtype is not None and np.issubdtype(dtype, kind)


@dataclasses.dataclass(frozen=True)
class Type:
    """A GraphBLAS scalar type: semantics (``dtype``) and device storage
    (``storage``) for a builtin or complex type; ``fields`` (name, Type)
    pairs for a user-defined struct type, whose ``dtype`` and
    ``storage`` are None."""

    name: str
    dtype: Optional[np.dtype] = None
    storage: Optional[torch.dtype] = None
    fields: Optional[Tuple[Tuple[str, "Type"], ...]] = None

    @staticmethod
    def udt(name: str, **field_types: "Type") -> "Type":
        """A user-defined struct type (reference ``GrB_Type_new``)."""
        return Type(name=name, fields=tuple(field_types.items()))

    @property
    def is_udt(self) -> bool:
        return self.fields is not None

    @property
    def is_builtin(self) -> bool:
        return not self.is_udt

    @property
    def is_unsigned(self) -> bool:
        return _sub(self.dtype, np.unsignedinteger)

    @property
    def is_bool(self) -> bool:
        return self.dtype is not None and self.dtype == np.bool_

    @property
    def is_integer(self) -> bool:
        return _sub(self.dtype, np.integer)

    @property
    def is_signed(self) -> bool:
        return _sub(self.dtype, np.signedinteger)

    @property
    def is_float(self) -> bool:
        """A real floating type (FP32, FP64)."""
        return _sub(self.dtype, np.floating)

    @property
    def is_complex(self) -> bool:
        return _sub(self.dtype, np.complexfloating)

    @property
    def nbits(self) -> int:
        return self.dtype.itemsize * 8 if self.dtype is not None else 0

    def zero(self):
        """The canonical padding value stored at absent entries (a dict
        of the fields' zeros for a user-defined type)."""
        if self.is_udt:
            return {k: t.zero() for k, t in self.fields}
        return np.zeros((), dtype=self.dtype)[()]

    def min_value(self):
        if self.is_bool:
            return False
        if self.is_integer:
            return np.iinfo(self.dtype).min
        return -np.inf

    def max_value(self):
        if self.is_bool:
            return True
        if self.is_integer:
            return np.iinfo(self.dtype).max
        return np.inf

    def storage_scalar(self, x):
        """A host scalar of this type as a Python number the storage
        dtype holds (unsigned values as the signed value of the same
        bits)."""
        return self.to_storage(np.asarray(x)).item()

    def to_storage(self, x: np.ndarray) -> np.ndarray:
        """Host values of this type as an array torch can hold: unsigned
        values are reinterpreted bit for bit as the signed type."""
        x = np.asarray(x).astype(self.dtype, copy=False)
        if self.is_unsigned:
            x = x.view(x.dtype.str.replace("u", "i"))
        return x

    def __repr__(self) -> str:  # pragma: no cover
        return f"Type({self.name})"


BOOL = Type("BOOL", np.dtype(np.bool_), torch.bool)
INT8 = Type("INT8", np.dtype(np.int8), torch.int8)
UINT8 = Type("UINT8", np.dtype(np.uint8), torch.int8)
INT16 = Type("INT16", np.dtype(np.int16), torch.int16)
UINT16 = Type("UINT16", np.dtype(np.uint16), torch.int16)
INT32 = Type("INT32", np.dtype(np.int32), torch.int32)
UINT32 = Type("UINT32", np.dtype(np.uint32), torch.int32)
INT64 = Type("INT64", np.dtype(np.int64), torch.int64)
UINT64 = Type("UINT64", np.dtype(np.uint64), torch.int64)
FP32 = Type("FP32", np.dtype(np.float32), torch.float32)
FP64 = Type("FP64", np.dtype(np.float64), torch.float64)
FC32 = Type("FC32", np.dtype(np.complex64), torch.complex64)
FC64 = Type("FC64", np.dtype(np.complex128), torch.complex128)

BUILTIN_TYPES = (BOOL, INT8, UINT8, INT16, UINT16, INT32, UINT32, INT64,
                 UINT64, FP32, FP64)

_BY_DTYPE = {t.dtype: t for t in BUILTIN_TYPES + (FC32, FC64)}
_BY_NAME = {t.name: t for t in BUILTIN_TYPES + (FC32, FC64)}


def type_of_dtype(dtype) -> Type:
    """Look up the GraphBLAS Type for a numpy dtype."""
    d = np.dtype(dtype)
    if d not in _BY_DTYPE:
        raise TypeError(f"no GraphBLAS type for dtype {d}")
    return _BY_DTYPE[d]


def type_by_name(name: str) -> Type:
    """Look up a builtin Type by its GraphBLAS name ("BOOL", "FP32", ...)."""
    if name not in _BY_NAME:
        raise TypeError(f"no builtin GraphBLAS type named {name!r}")
    return _BY_NAME[name]


_BY_STORAGE = {t.storage: t for t in BUILTIN_TYPES + (FC32, FC64)
               if not t.is_unsigned}


def type_of_storage(dtype: torch.dtype) -> Type:
    """The signed, float or complex Type whose storage is ``dtype``."""
    if dtype not in _BY_STORAGE:
        raise TypeError(f"no GraphBLAS type stored as {dtype}")
    return _BY_STORAGE[dtype]


# Code lattice for implicit output-type deduction, mirroring the
# reference's GB_code_* ordering (Source/GB_code_type.c): bool < int8 <
# uint8 < ... < fp64 (< fc32 < fc64, as later versions of the reference
# number them).
_ORDER = {t.name: i for i, t in enumerate(BUILTIN_TYPES + (FC32, FC64))}


def promote(a: Type, b: Type) -> Type:
    """The later of two types in the reference's type-code order."""
    return a if _ORDER[a.name] >= _ORDER[b.name] else b


def ordered(x: torch.Tensor, t: Type) -> torch.Tensor:
    """Values of type ``t`` as keys that compare in ``t``'s order: the
    storage itself, except for unsigned types, whose values become int64
    (UINT8/16/32 zero-extended; UINT64 with its top bit flipped, which
    maps the unsigned order onto the signed one)."""
    if not t.is_unsigned:
        return x
    if t.nbits < 64:
        return x.to(torch.int64) & ((1 << t.nbits) - 1)
    return x ^ torch.iinfo(torch.int64).min


def from_ordered(k: torch.Tensor, t: Type) -> torch.Tensor:
    """Inverse of :func:`ordered`: keys back to ``t``'s storage."""
    if not t.is_unsigned:
        return k
    if t.nbits < 64:
        return k.to(t.storage)
    return k ^ torch.iinfo(torch.int64).min


def _int_value(x: torch.Tensor, src: Type) -> torch.Tensor:
    """Integer values of type ``src`` as int64 holding the same number
    modulo 2^64 (unsigned narrow types zero-extended)."""
    if src.is_unsigned and src.nbits < 64:
        return x.to(torch.int64) & ((1 << src.nbits) - 1)
    return x.to(torch.int64)


def _float_value(x: torch.Tensor, src: Type) -> torch.Tensor:
    """Values of type ``src`` as float64 (UINT64 read as unsigned)."""
    if src.is_unsigned:
        v = _int_value(x, src).to(torch.float64)
        if src.nbits == 64:
            v = torch.where(x < 0, v + 2.0 ** 64, v)
        return v
    return x.to(torch.float64)


def cast(x: torch.Tensor, to_type: Type,
         src: Optional[Type] = None) -> torch.Tensor:
    """Cast a tensor of type ``src`` (default: the type its storage
    dtype names, signed) to ``to_type``'s storage with GraphBLAS
    (C-style) semantics, as the JAX package's ``cast`` does.

    Reference: ``Source/GB_cast_factory.c`` /
    ``Template/GB_2type_template.c``.  A struct value passes unchanged
    into a user-defined type; a builtin value cast to one, or a struct
    value cast to a builtin type, raises ``TypeError``."""
    if to_type.is_udt:
        if isinstance(x, dict) and (src is None or src.is_udt):
            return x
        raise TypeError("cannot cast builtin values to a user-defined type")
    if isinstance(x, dict) or (src is not None and src.is_udt):
        raise TypeError("cannot cast user-defined values to a builtin type")
    if src is None:
        src = type_of_storage(x.dtype)
    if src.name == to_type.name:
        return x
    dst = to_type.storage
    if to_type.is_bool:
        return x != 0
    if src.is_bool:
        return x.to(dst)
    if src.is_complex:
        if to_type.is_complex:
            return x.to(dst)
        # the real part, then the float rules (the JAX package's)
        return cast(x.real.contiguous(), to_type,
                    FP32 if src.name == "FC32" else FP64)
    if to_type.is_complex:
        if src.is_unsigned:
            return _float_value(x, src).to(dst)
        return x.to(dst)
    if src.is_float and to_type.is_integer:
        # truncate toward zero; NaN -> 0; out of range (inf included)
        # saturates to the type's min/max (the JAX package's choice)
        info = np.iinfo(to_type.dtype)
        t = torch.trunc(torch.where(torch.isnan(x), 0, x)).to(torch.float64)
        hi, lo = float(info.max), float(info.min)
        in_range = (t < hi) & (t > lo)
        tv = torch.where(in_range, t, 0.0)
        if to_type.is_unsigned and to_type.nbits == 64:
            # values in [2^63, 2^64) have the int64 bits of v - 2^64
            tv = torch.where(tv >= 2.0 ** 63, tv - 2.0 ** 64, tv)
        conv = tv.to(torch.int64)
        conv = torch.where(t >= hi, to_type.storage_scalar(info.max), conv)
        conv = torch.where(t <= lo, to_type.storage_scalar(info.min), conv)
        return conv.to(dst)
    if src.is_integer and to_type.is_integer:
        # modular: the low bits of the (zero- or sign-extended) value
        return _int_value(x, src).to(dst)
    if src.is_integer and to_type.is_float:
        if src.is_unsigned:
            return _float_value(x, src).to(dst)
        return x.to(dst)
    return x.to(dst)


def cast_result(z, t: Type):
    """An operator's result in ``t``'s storage: as it is when its dtype
    is that storage, else cast from the type its dtype names (a user op
    may return, say, a bool tensor for a UINT32 ztype); a struct result
    of a user-defined ``t`` field by field."""
    if t.is_udt:
        if not isinstance(z, dict):
            cast(z, t)                  # raises: builtin values
        return {k: cast_result(z[k], ft) if ft.is_udt or isinstance(
            z[k], torch.Tensor) else torch.as_tensor(z[k], dtype=ft.storage)
                for k, ft in t.fields}
    if z.dtype == t.storage:
        return z
    return cast(z, t, type_of_storage(z.dtype))


def cast_value(x, to_type: Type):
    """Cast a Python or numpy scalar to a numpy scalar of ``to_type``
    (its own dtype: a UINT64 value stays unsigned), with :func:`cast`'s
    rules: NaN -> 0 and saturation for float -> int, ``x != 0`` for
    bool; a dict of the fields' values for a user-defined type."""
    if to_type.is_udt:
        if not isinstance(x, dict):
            raise TypeError("cannot cast builtin values to a user-defined "
                            "type")
        return {k: cast_value(x[k], t) for k, t in to_type.fields}
    if isinstance(x, dict):
        raise TypeError("cannot cast user-defined values to a builtin type")
    if to_type.is_bool:
        return np.bool_(x != 0)
    if to_type.is_integer and isinstance(
            x, (complex, np.complexfloating)):
        x = float(np.real(x))
    elif to_type.is_float and isinstance(x, (complex, np.complexfloating)):
        x = np.real(x)
    if to_type.is_integer and isinstance(x, (float, np.floating)):
        info = np.iinfo(to_type.dtype)
        if np.isnan(x):
            return np.asarray(0, to_type.dtype)[()]
        xi = np.trunc(x)
        if xi >= float(info.max):
            return np.asarray(info.max, to_type.dtype)[()]
        if xi <= float(info.min):
            return np.asarray(info.min, to_type.dtype)[()]
        return np.asarray(int(xi), dtype=to_type.dtype)[()]
    return np.asarray(x).astype(to_type.dtype)[()]


def zero_of(t: Type):
    """The type's zero as a numpy scalar (the padding value)."""
    return t.zero()


def zeros_like_typed(shape, t: Type, device):
    """Zeros of type ``t`` (its storage; a dict of the fields' zeros for
    a user-defined type) on ``device``."""
    if t.is_udt:
        return {k: zeros_like_typed(shape, ft, device) for k, ft in t.fields}
    return torch.zeros(shape, dtype=t.storage, device=device)


def full_typed(shape, value, t: Type, device):
    """``value`` (a host scalar of ``t``; a dict for a user-defined
    type) broadcast to ``shape`` in ``t``'s storage on ``device``."""
    if t.is_udt:
        return {k: full_typed(shape, value[k], ft, device)
                for k, ft in t.fields}
    return torch.full(shape, t.storage_scalar(value), dtype=t.storage,
                      device=device)


def tree_where(mask: torch.Tensor, a, b):
    """``torch.where`` lifted over struct values (``mask`` broadcasts
    to every leaf; a leaf of ``b`` may be a scalar)."""
    return tree_map(lambda x, y: torch.where(mask, x, y), a, b)


def value_take(vals, idx):
    """``vals[idx]`` on every leaf of a (struct) value."""
    return tree_map(lambda v: v[idx], vals)


def value_shape(vals) -> tuple:
    """The value shape of a (struct) value: its first leaf's."""
    while isinstance(vals, dict):
        vals = vals[sorted(vals)[0]]
    return tuple(vals.shape)
