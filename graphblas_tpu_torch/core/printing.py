"""Object printing and validity checking.

Counterpart of ``graphblas_tpu/core/printing.py``: the same text, byte
for byte.  Reference: the ``GB_check`` family — one checker/printer per
object type at 4 verbosity levels (``GB.h:768-806``: silent/terse/
summary/complete), exposed as ``GxB_*_fprint``; plus ``Test/spok``
validating sparse-matrix invariants.  Output format follows
``GB_matvec_check.c``'s shape ("nrows: .. ncols: ..", per-row entry
listing).

Values print as numpy scalars of the type's dtype (a tensor prints as
``tensor(1.5)``, and a float32 through Python's ``float`` gains digits),
so each value is taken to the host through the containers' own
accessors first.  The sparse invariants run as reductions on the
container's device, with one small read back; a sparse listing copies
only the entries it prints.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map
from .descriptor import Descriptor
from .matrix import Matrix, Vector, host_values
from .monoids import Monoid
from .ops import BinaryOp, SelectOp, UnaryOp
from .semirings import Semiring
from .types import Type

__all__ = ["fprint", "check", "SILENT", "SUMMARY", "SHORT", "COMPLETE"]

SILENT = 0    # GxB_SILENT
SUMMARY = 1   # GxB_SUMMARY
SHORT = 2     # GxB_SHORT
COMPLETE = 3  # GxB_COMPLETE


def check(obj: Any) -> bool:
    """Validate object invariants (GB_check / spok analogue).

    Raises ValueError on a violated invariant; returns True otherwise.
    """
    if isinstance(obj, (Matrix, Vector)):
        m = obj.wait()
        pat = m.pattern
        for leaf in tree_leaves(m.values):
            if leaf.shape != pat.shape:
                raise ValueError("values/pattern shape mismatch")
            if bool((leaf[~pat] != 0).any()):
                raise ValueError("nonzero value at absent position "
                                 "(canonical invariant violated)")
        return True
    if isinstance(obj, Semiring):
        if not obj.add.type.is_udt and \
                obj.add.type.name != obj.mult.ztype.name:
            raise ValueError("semiring monoid/mult domain mismatch")
        return True
    if isinstance(obj, (Type, UnaryOp, BinaryOp, Monoid, SelectOp,
                        Descriptor)):
        return True
    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    if isinstance(obj, HyperCscMatrix):
        return _check_hyper(obj.tr)   # stored transpose carries invariants
    if isinstance(obj, HyperMatrix):
        return _check_hyper(obj)
    csr = _as_plain_csr(obj)
    if csr is not None:
        # spok-style CSR invariants (Test/spok): pointer endpoints,
        # monotone pointers, in-range strictly sorted entries, padding
        # sentinels intact; each flag is one device reduction and the
        # flags cross to the host together, checked in the reference's
        # order
        nv, nr, nc = csr.nvals, csr.nrows, csr.ncols
        ip = csr.indptr.long()
        I, J = csr.rowids.long(), csr.indices.long()
        lin = I[:nv] * nc + J[:nv]
        flags = torch.stack([
            (ip[0] != 0) | (ip[-1] != nv),
            (ip[1:] < ip[:-1]).any(),
            ((J[:nv] < 0) | (J[:nv] >= nc)).any(),
            (lin[1:] <= lin[:-1]).any(),
            (J[nv:] != nc).any() | (I[nv:] != nr).any()]).tolist()
        for bad, msg in zip(flags, (
                "indptr endpoints violated", "indptr not monotone",
                "column index out of range",
                "entries not strictly sorted by (i,j)",
                "padding sentinels corrupted")):
            if bad:
                raise ValueError(msg)
        return True
    raise TypeError(f"not a GraphBLAS object: {type(obj)}")


def _as_plain_csr(obj):
    # CsrMatrix view of a sparse container (None if not one)
    from ..sparse.container import CscMatrix, CsrMatrix
    if isinstance(obj, CsrMatrix):
        return obj
    if isinstance(obj, CscMatrix):
        return obj.tr
    return None


def _check_hyper(H) -> bool:
    # hyper invariants: row list strictly sorted + in range, hptr
    # monotone with matching endpoints (GB_matrix.h hyper rules); the
    # entries' (i, j) pairs strictly sorted, each row in the list and
    # each column in range.  Pairs compare as (i, j) without a linear
    # key, which would overflow int64 at dimensions up to 2^60.
    nvec, nv = H.nvec, H.nvals
    h = H.h[:nvec]
    hp = H.hptr.long()
    I, J = H.rowids[:nv], H.indices[:nv]
    di, dj = I[1:] - I[:-1], J[1:] - J[:-1]
    flags = torch.stack([
        (h[1:] <= h[:-1]).any() | (h < 0).any() | (h >= H.nrows).any(),
        (hp[0] != 0) | (hp[nvec] != nv) | (hp[1:] < hp[:-1]).any(),
        ((di < 0) | ((di == 0) & (dj <= 0))).any()
        | (J < 0).any() | (J >= H.ncols).any()
        | ~torch.isin(I, h).all()]).tolist()
    for bad, msg in zip(flags, (
            "hyper row list not strictly sorted in range",
            "hyper pointers violated",
            "hyper entries not strictly sorted in range")):
        if bad:
            raise ValueError(msg)
    return True


def _head_tuples(A, limit: int):
    """The first ``limit`` (I, J, X) of ``A.extractTuples()`` (CSR, CSC
    or hypersparse), copying only those entries to the host."""
    from ..sparse.container import CscMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    A = A.wait()
    by_col = isinstance(A, (CscMatrix, HyperCscMatrix))
    S = A.tr if by_col else A
    k = min(limit, S.nvals)
    I = S.rowids[:k].cpu().numpy().astype(np.int64)
    J = S.indices[:k].cpu().numpy().astype(np.int64)
    X = host_values(tree_map(lambda v: v[:k], S.values), S.type)
    return (J, I, X) if by_col else (I, J, X)


def fprint(obj: Any, name: str = "", level: int = SHORT,
           file=None) -> None:
    """Pretty-print any GraphBLAS object (``GxB_*_fprint``)."""
    out = file or sys.stdout
    w = out.write
    if level <= SILENT:
        check(obj)
        return

    from ..sparse.hyper import HyperMatrix
    from ..sparse.hyper_csc import HyperCscMatrix
    if _as_plain_csr(obj) is not None or isinstance(
            obj, (HyperMatrix, HyperCscMatrix)):
        is_csc = type(obj).__name__ == "CscMatrix"
        fmt = "by_col (CSC)" if is_csc else (
            "hypersparse" if type(obj).__name__ == "HyperMatrix"
            else "hypersparse by_col (CSC)"
            if isinstance(obj, HyperCscMatrix) else "by_row (CSR)")
        w(f"\nGraphBLAS matrix: {name} \nnrows: {obj.nrows} "
          f"ncols: {obj.ncols} \nGraphBLAS type:  "
          f"{obj.type.name.lower()} format: {fmt} nvals: {obj.nvals}\n")
        if level >= SHORT and not obj.type.is_udt:
            limit = obj.nvals if level >= COMPLETE else min(obj.nvals, 30)
            I, J, X = _head_tuples(obj, limit)
            for k in range(limit):
                w(f"    ({I[k]},{J[k]})   {X[k]}\n")
            if limit < obj.nvals:
                w("    ...\n")
        check(obj)
        return
    if isinstance(obj, (Matrix, Vector)):
        m = obj.wait()
        is_vec = isinstance(obj, Vector)
        kind = "vector" if is_vec else "matrix"
        pat = m.pattern_np()
        nvals = int(pat.sum())
        if is_vec:
            w(f"\nGraphBLAS {kind}: {name} \nn: {pat.shape[0]} ")
        else:
            w(f"\nGraphBLAS {kind}: {name} \nnrows: {pat.shape[0]} "
              f"ncols: {pat.shape[1]} ")
        size = m.type.fields and "struct" or np.dtype(m.type.dtype).itemsize
        w(f"\nGraphBLAS type:  {m.type.name.lower()} size: {size}\n")
        w(f"number of entries: {nvals} \n")
        if level >= SHORT:
            vals = m.to_dense()
            limit = None if level >= COMPLETE else 30
            shown = 0
            if is_vec:
                for i in np.nonzero(pat)[0]:
                    if limit and shown >= limit:
                        w("    ...\n")
                        break
                    w(f"    index {i}: {_val(vals, (i,), m.type)}\n")
                    shown += 1
            else:
                for i in range(pat.shape[0]):
                    cols = np.nonzero(pat[i])[0]
                    if not len(cols):
                        continue
                    if limit and shown >= limit:
                        w("    ...\n")
                        break
                    w(f"row: {i} : {len(cols)} entries\n")
                    for j in cols:
                        if limit and shown >= limit:
                            break
                        w(f"    column {j}: {_val(vals, (i, j), m.type)}\n")
                        shown += 1
        check(obj)
        return

    if isinstance(obj, Type):
        sz = "struct" if obj.is_udt else np.dtype(obj.dtype).itemsize
        w(f"\nGraphBLAS type: {name} {obj.name.lower()} size: {sz}\n")
        return
    if isinstance(obj, UnaryOp):
        w(f"\nGraphBLAS UnaryOp: {name} z={obj.name.lower()}(x) "
          f"type: {obj.ztype.name} <- {obj.xtype.name}\n")
        return
    if isinstance(obj, BinaryOp):
        w(f"\nGraphBLAS BinaryOp: {name} z={obj.name.lower()}(x,y) "
          f"type: {obj.ztype.name} <- {obj.xtype.name} x {obj.ytype.name}\n")
        return
    if isinstance(obj, SelectOp):
        w(f"\nGraphBLAS SelectOp: {name} {obj.name.lower()}(A,k)\n")
        return
    if isinstance(obj, Monoid):
        w(f"\nGraphBLAS Monoid: {name} {obj.name.lower()} "
          f"identity: {obj.identity}"
          + (f" terminal: {obj.terminal}" if obj.terminal is not None
             else "") + "\n")
        return
    if isinstance(obj, Semiring):
        w(f"\nGraphBLAS Semiring: {name} {obj.name.lower()}\n")
        if level >= SHORT:
            fprint(obj.add, "add", SUMMARY, out)
            fprint(obj.mult, "multiply", SUMMARY, out)
        return
    if isinstance(obj, Descriptor):
        w(f"\nGraphBLAS Descriptor: {name} replace={obj.replace} "
          f"scmp={obj.mask_scmp} tran0={obj.tran0} tran1={obj.tran1} "
          f"axb={obj.axb_method or 'default'}\n")
        return
    raise TypeError(f"not a GraphBLAS object: {type(obj)}")


def _val(vals, idx, t: Type) -> str:
    if t.is_udt:
        # fields in sorted-name order, as the JAX package's pytree
        # dicts list them
        return "{" + ", ".join(f"{k}: {np.asarray(v)[idx]}"
                               for k, v in sorted(vals.items())) + "}"
    v = np.asarray(vals)[idx]
    if t.is_bool:
        return f"bool {int(v)}"
    return f"{t.name.lower()} {v}"
