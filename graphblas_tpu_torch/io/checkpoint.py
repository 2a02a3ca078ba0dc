"""Checkpoint / resume: matrix serialization.

Counterpart of ``graphblas_tpu/io/checkpoint.py``, with the same
``.npz`` layout, so an archive written by either package loads in the
other.  The reference's persistence story is O(1) import/export of raw
arrays plus triplet text files (SURVEY §5 "Checkpoint/resume"); this
module adds the binary form: matrices round-trip through ``.npz`` (CSR
arrays + dtype tag), vectors likewise.  Works for any builtin type;
user-defined struct types save one array per (possibly nested) field,
under ``field.<path>`` keys, from any container.
"""

from __future__ import annotations

import numpy as np

from ..core.io_export import export_csr, import_csr
from ..core.matrix import Matrix, Vector
from ..core.types import Type, type_of_dtype

__all__ = ["save_matrix", "load_matrix", "save_vector", "load_vector"]


def _flatten_udt(X, prefix=""):
    out = {}
    for k, v in X.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_udt(v, key + "."))
        else:
            out[key] = v
    return out


def save_matrix(path, A) -> None:
    """Serialize a Matrix, CsrMatrix or other matrix container to .npz
    (CSR arrays; a struct type saves its tuples, one array per (possibly
    nested) field)."""
    if A.type.is_udt:
        I, J, X = A.extractTuples()
        fields = {f"field.{k}": v for k, v in _flatten_udt(X).items()}
        np.savez_compressed(path, kind="udt", typename=A.type.name,
                            nrows=A.nrows, ncols=A.ncols, I=I, J=J,
                            **fields)
        return
    nr, nc, p, j, x = export_csr(A)
    np.savez_compressed(path, kind="csr", nrows=nr, ncols=nc,
                        indptr=p, indices=j, values=x)


def load_matrix(path, type: Type = None, as_csr: bool = False,
                device=None):
    """Load a matrix saved by :func:`save_matrix`, as a bitmap Matrix or,
    with ``as_csr``, a CsrMatrix, on the card unless ``device`` says.
    Struct archives need the matching ``type`` passed in (the Type
    carries the field map); the tuples land in one build."""
    z = np.load(path, allow_pickle=False)
    nr, nc = int(z["nrows"]), int(z["ncols"])
    if str(z["kind"]) == "udt":
        if type is None or not type.is_udt:
            raise ValueError("loading a UDT archive requires type=")
        I, J = z["I"], z["J"]

        def field(t, prefix=""):
            return {k: (field(ft, f"{prefix}{k}.") if ft.is_udt else
                        z[f"field.{prefix}{k}"])
                    for k, ft in t.fields}
        X = field(type)
        if as_csr:
            from ..sparse.container import csr_from_coo
            return csr_from_coo(I, J, X, nr, nc, type=type, device=device)
        return _udt_matrix(I, J, X, nr, nc, type, device)
    t = type or type_of_dtype(z["values"].dtype)
    C = import_csr(nr, nc, z["indptr"], z["indices"], z["values"], t,
                   device=device)
    return C if as_csr else C.to_matrix()


def _udt_matrix(I, J, X, nrows: int, ncols: int, t: Type, device):
    """A bitmap Matrix of a struct type from duplicate-free tuples: each
    field scattered into a dense host array, then one ``from_dense``."""
    def dense(x, ft):
        if ft.is_udt:
            return {k: dense(x[k], f) for k, f in ft.fields}
        d = np.zeros((nrows, ncols), ft.dtype)
        d[I, J] = x
        return d
    pat = np.zeros((nrows, ncols), bool)
    pat[I, J] = True
    return Matrix.from_dense(dense(X, t), t, pattern=pat, device=device)


def save_vector(path, v: Vector) -> None:
    I, X = v.extractTuples()
    np.savez_compressed(path, kind="vec", n=v.size, I=I, X=X)


def load_vector(path, type: Type = None, device=None) -> Vector:
    z = np.load(path, allow_pickle=False)
    t = type or type_of_dtype(z["X"].dtype)
    return Vector.from_coo(z["I"], z["X"], int(z["n"]), type=t,
                           device=device)
