"""Graph / matrix I/O: triplet files, MatrixMarket, and the demo pipeline.

Counterpart of ``graphblas_tpu/io/read.py``.  Reference behavior being
matched (not translated): ``Demo/Source/read_matrix.c`` reads
whitespace "i j x" triplet lines (0- or 1-based), optionally drops self
edges, builds with dup=PLUS (LOR if boolean), and optionally
symmetrizes as A=(C+C')/2 (square) or the bipartite [0 C; C' 0]
(rectangular).  ``Demo/Source/get_matrix.c`` front-ends it with
generated Wathen / random matrices.

The native C parser (:mod:`graphblas_tpu_torch.io.native`) is used when
the shared library is built; the numpy path is the portable fallback,
with the same line policy.  The matrices are bitmap ``Matrix``
containers, as the JAX package's, on the card unless ``device`` says.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, Tuple

import numpy as np

from ..core.descriptor import TRAN1
from ..core.matrix import Matrix
from ..core.ops import binary
from ..core.types import BOOL, FP64
from ..ops.ewise import eWiseAdd

__all__ = ["read_triplets", "read_matrix", "write_triplets", "mmread",
           "get_matrix"]

# lines per chunk of write_triplets' text (bounds the string it builds)
_WRITE_CHUNK = 1 << 20


def read_triplets(source) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse "i j x" triplet lines -> (I, J, X) numpy arrays.

    Accepts a path, file object, or string.  Policy (identical in the
    native C parser and this fallback): a data line needs >= 2 numeric
    tokens — indices first, then an optional value (default 1.0); tokens
    past the 3rd are ignored; lines starting with '%' or '#' are
    comments; a malformed token among the first 3 raises ValueError.
    """
    if isinstance(source, (str, os.PathLike)):
        from .native import parse_triplets_native
        parsed = parse_triplets_native(str(source))
        if parsed is not None:
            return parsed
        with open(source) as f:
            text = f.read()
    elif hasattr(source, "read"):
        text = source.read()
    else:
        text = source
    try:
        # fast vectorized path for well-formed consistent-column files
        arr = np.loadtxt(_io.StringIO(text), ndmin=2, dtype=np.float64,
                         comments=("%", "#"))
        if arr.shape[0] and arr.shape[1] < 2:
            raise ValueError("data line with fewer than 2 columns")
    except ValueError:
        # mixed 2/3-column (or >3-column) files: per-line parse with the
        # same policy as the C parser; float() == strtod token rules
        rows = []
        for ln in text.splitlines():
            # '%' and '#' start a comment anywhere on the line
            for c in "%#":
                cut = ln.find(c)
                if cut >= 0:
                    ln = ln[:cut]
            s = ln.strip()
            if not s:
                continue
            parts = s.split()
            if len(parts) < 2:
                raise ValueError(
                    f"malformed triplet line (need >=2 columns): {s!r}")
            try:
                rows.append((float(parts[0]), float(parts[1]),
                             float(parts[2]) if len(parts) > 2 else 1.0))
            except ValueError:
                raise ValueError(f"malformed triplet line: {s!r}") from None
        arr = np.asarray(rows, np.float64).reshape(-1, 3)
    if arr.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    I = arr[:, 0].astype(np.int64)
    J = arr[:, 1].astype(np.int64)
    X = arr[:, 2] if arr.shape[1] > 2 else np.ones(len(I), np.float64)
    return I, J, X


def write_triplets(path, M, one_based: bool = False):
    """Write a matrix (any container with ``extractTuples``) as "i j x"
    triplet lines (kron .tsv interchange): the JAX package's bytes,
    formatted a chunk of lines at a time."""
    I, J, X = M.extractTuples()
    off = 1 if one_based else 0
    line = "{}\t{}\t{:d}\n" if M.type.is_bool else "{}\t{}\t{:.17g}\n"
    with open(path, "w") as f:
        for s in range(0, len(I), _WRITE_CHUNK):
            e = s + _WRITE_CHUNK
            x = X[s:e]
            xs = x.astype(np.int64) if M.type.is_bool else x
            f.write("".join(map(line.format, (I[s:e] + off).tolist(),
                                (J[s:e] + off).tolist(), xs.tolist())))


def read_matrix(source,
                make_symmetric: bool = False,
                no_self_edges: bool = False,
                boolean: bool = False,
                one_based: bool = False,
                nrows: Optional[int] = None,
                ncols: Optional[int] = None,
                device=None) -> Matrix:
    """Triplet file -> Matrix with the demo pipeline's exact semantics.

    (reference ``read_matrix.c``: dims = 1+max index, dup=PLUS (LOR when
    boolean), optional self-edge prune, optional symmetrize.)
    """
    I, J, X = read_triplets(source)
    if one_based:
        I, J = I - 1, J - 1
    # dims first, then prune — and never prune for the rectangular
    # bipartite case, where (i,i) is not a self edge of [0 C; C' 0]
    # (read_matrix.c:140-187)
    if nrows is None:
        nrows = int(I.max()) + 1 if I.size else 0
    if ncols is None:
        ncols = int(J.max()) + 1 if J.size else 0
    if no_self_edges and not (make_symmetric and nrows != ncols):
        keep = I != J
        I, J, X = I[keep], J[keep], X[keep]
    if boolean:
        t, dup = BOOL, binary.lor[BOOL]
        X = X != 0
    else:
        t, dup = FP64, binary.plus[FP64]
    C = Matrix.from_coo(I, J, X, nrows, ncols, type=t, dup=dup,
                        device=device)
    if not make_symmetric:
        return C
    if nrows == ncols:
        # A = (C + C')/2 ; boolean: A = C | C'
        A = eWiseAdd(Matrix.new(t, nrows, nrows, device=C.device), None,
                     None, binary.lor[BOOL] if boolean else
                     binary.plus[FP64], C, C, TRAN1)
        if boolean:
            return A
        return Matrix(A.values * 0.5, A.pattern, FP64).canonical()
    # rectangular: bipartite A = [0 C ; C' 0]
    n = nrows + ncols
    Ii = np.concatenate([I, J + nrows])
    Jj = np.concatenate([J + nrows, I])
    Xx = np.concatenate([X, X])
    return Matrix.from_coo(Ii, Jj, Xx, n, n, type=t, dup=dup,
                           device=C.device)


def mmread(source, device=None) -> Matrix:
    """MatrixMarket coordinate reader (1-based, %%MatrixMarket header)."""
    if isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            text = f.read()
    elif hasattr(source, "read"):
        text = source.read()
    else:
        text = source
    lines = [ln for ln in text.splitlines()]
    sym = "symmetric" in lines[0].lower() if lines else False
    pattern = "pattern" in lines[0].lower() if lines else False
    body = [ln for ln in lines if ln.strip() and not ln.startswith("%")]
    m, n, _nz = (int(v) for v in body[0].split()[:3])
    data = np.loadtxt(_io.StringIO("\n".join(body[1:])), ndmin=2) \
        if len(body) > 1 else np.zeros((0, 3))
    I = data[:, 0].astype(np.int64) - 1 if data.size else np.zeros(0, np.int64)
    J = data[:, 1].astype(np.int64) - 1 if data.size else np.zeros(0, np.int64)
    X = (np.ones(len(I)) if (pattern or data.shape[1] < 3)
         else data[:, 2])
    if sym:
        off = I != J
        I = np.concatenate([I, J[off]])
        J = np.concatenate([J, I[:len(X)][off]])
        X = np.concatenate([X, X[off]])
    return Matrix.from_coo(I, J, X, m, n, type=FP64,
                           dup=binary.plus[FP64], device=device)


def get_matrix(source=None, nx: int = 4, ny: int = 4,
               make_symmetric: bool = False, no_self_edges: bool = False,
               boolean: bool = False, method: int = 0,
               random: bool = False, nrows: int = 1000, ncols: int = 1000,
               ntuples: int = 10000, seed: int = 1, device=None) -> Matrix:
    """Demo matrix front-end (reference ``get_matrix.c``): read a file if
    given, else generate a Wathen FEM matrix (or a random one)."""
    if source is not None:
        return read_matrix(source, make_symmetric=make_symmetric,
                           no_self_edges=no_self_edges, boolean=boolean,
                           device=device)
    from ..models.generate import random_matrix, wathen
    if random:
        return random_matrix(nrows, ncols, ntuples, seed=seed,
                             make_symmetric=make_symmetric,
                             no_self_edges=no_self_edges, boolean=boolean,
                             device=device)
    return wathen(nx, ny, method=method, device=device)
