"""Pending tuples + element mutation on the sparse containers.

Counterpart of ``graphblas_tpu/sparse/pending.py``.  Reference:
``GB_setElement.c:10-28`` (not-present entry -> pending tuple),
``GB_pending_add.c`` (the in-matrix unsorted delta list),
``GB_wait.c:240-350`` (prune zombies, build the delta, disjoint merge),
``GB_resize.c`` (prune outside entries).  ``CsrMatrix`` (and through
its stored transpose ``CscMatrix``) gets the surface the bitmap
containers have (``core/matrix.py``):

* ``setElement`` appends ``(i, j, scalar, accum)`` to the container's
  host-side ``_pending`` list — O(1), no device work;
* ``wait`` folds the whole list in batches: per same-accum run,
  duplicates fold on the host in input order (``GB_builder``'s dup
  assembly), then ONE device union merge lands the run
  (``csr_ewise_add`` with SECOND — overwrite — or the run's accum on
  intersections, exactly ``GB_wait``'s A = A + T);
* ``removeElement`` waits then prunes the lane (the functional form of
  a zombie + immediate ``GB_wait``);
* ``resize`` remaps entries through truncated identity maps on device.

``HyperMatrix`` (and through their wrapped containers ``HyperCscMatrix``
and ``SparseVec``) folds the same way with pair-key union merges
(``hyper_ewise``); its resize is a tuple filter on the device, since a
dimension-sized index map is impossible at 2^60.

Over a user-defined type the tuples' values are dicts; a run folds on
the host field by field, position by position within the duplicate
runs, with the run's accum applied to CPU tensors (the JAX package
folds tuple by tuple), and merges with SECOND or the accum as above, on
CSR and on the hypersparse containers alike (the JAX package raises
for the latter).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.errors import IndexOutOfBounds
from ..core.matrix import (_fold_runs, device_values, global_blocking,
                           host_values, pending_runs)
from ..core.ops import BinaryOp
from ..core.options import public_options
from ..core.types import Type, cast_result, cast_value
from ..utils import faultinject
from ..utils.tree import tree_leaves, tree_map

__all__ = ["fold_pending_csr", "fold_pending_hyper", "csr_resize",
           "hyper_resize", "check_index", "append_pending"]


def check_index(A, i: int, j: int):
    if not (0 <= int(i) < A.nrows and 0 <= int(j) < A.ncols):
        raise IndexOutOfBounds(
            f"index ({i}, {j}) out of range for {A.nrows}x{A.ncols}")


def append_pending(A, i: int, j: int, value, accum: Optional[BinaryOp],
                   blocking: Optional[bool]):
    """Shared setElement body: shallow-copy the container with one more
    pending tuple (``GB_pending_add``), folding immediately in blocking
    mode (``GB_block.c:34-38``)."""
    check_index(A, i, j)
    if accum is not None and not isinstance(accum, BinaryOp):
        raise TypeError(f"setElement accum must be a BinaryOp, got "
                        f"{accum!r}")
    if blocking is None:
        blocking = global_blocking()
    out = A._shallow()
    out._pending = A._pending.plus((int(i), int(j), value, accum))
    return out.wait() if blocking else out


def _runs(pending) -> List[Tuple]:
    """Group consecutive same-accum tuples (order matters: a later
    overwrite must not fold across an intervening accum run)."""
    return pending_runs(pending)


def _fold_run_host(tuples, accum: Optional[BinaryOp], t: Type):
    """Dedup one run on the host in input order -> sorted (I, J, X)."""
    ii = np.asarray([p[0] for p in tuples], np.int64)
    jj = np.asarray([p[1] for p in tuples], np.int64)
    if t.is_udt:
        xs = _stack_struct([cast_value(p[2], t) for p in tuples], t)
    else:
        xs = np.asarray([cast_value(p[2], t) for p in tuples],
                        dtype=np.dtype(t.dtype))
    order = np.lexsort((np.arange(len(ii)), jj, ii))  # stable in input order
    ii, jj = ii[order], jj[order]
    xs = tree_map(lambda a: a[order], xs)
    first = np.ones(len(ii), bool)
    first[1:] = (ii[1:] != ii[:-1]) | (jj[1:] != jj[:-1])
    starts = np.nonzero(first)[0]
    if t.is_udt:
        return ii[starts], jj[starts], _fold_struct_runs(xs, starts, accum,
                                                          t)
    return ii[starts], jj[starts], _fold_runs(xs, starts, accum, t)


def _stack_struct(scalars, t: Type):
    """Host struct scalars (dicts) as a dict of field arrays."""
    return {k: (_stack_struct([x[k] for x in scalars], ft) if ft.is_udt
                else np.asarray([x[k] for x in scalars], ft.dtype))
            for k, ft in t.fields}


def _fold_struct_runs(xs, starts: np.ndarray, accum: Optional[BinaryOp],
                      t: Type):
    """Each sorted run of struct values folded left to right with
    ``accum`` (the last write without one), batched by position within
    the runs: accum runs on CPU tensors of the fields' storage."""
    ends = np.append(starts[1:], len(tree_leaves(xs)[0]))
    if accum is None:
        return tree_map(lambda a: a[ends - 1], xs)
    out = tree_map(lambda a: a[starts].copy(), xs)
    for k in range(1, int((ends - starts).max(initial=1))):
        sel = starts + k < ends
        a = device_values(tree_map(lambda v: v[sel], out), t, "cpu")
        b = device_values(tree_map(lambda v: v[starts[sel] + k], xs), t,
                          "cpu")
        z = host_values(cast_result(accum(a, b), t), t)

        def put(o, zz):
            o[sel] = zz
        tree_map(put, out, z)
    return out


def _merge_op(accum: Optional[BinaryOp], t: Type) -> BinaryOp:
    """Merge operator against existing entries: overwrite (SECOND) when
    no accum — GB_setElement's found-entry semantics."""
    if accum is not None:
        return accum
    if t.is_udt:
        # the op families cache by type name, which two structs may share
        return BinaryOp("SECOND", lambda x, y: y, t, t, t)
    from ..core.ops import binary
    return binary.second[t]


def fold_pending_csr(A):
    """GB_wait on CsrMatrix: one union merge per accum run."""
    faultinject.checkpoint("csr_wait")
    from .container import csr_from_coo
    from .ewise import csr_ewise_add
    out = A
    for accum, tuples in _runs(A._pending):
        I, J, X = _fold_run_host(tuples, accum, A.type)
        D = csr_from_coo(I, J, X, A.nrows, A.ncols, type=A.type,
                         sum_duplicates=False, device=A.device)
        out = csr_ewise_add(_merge_op(accum, A.type), out, D)
    out._options.update(public_options(A._options))
    return out


def fold_pending_hyper(A):
    """GB_wait on HyperMatrix: one pair-key union merge per accum run."""
    faultinject.checkpoint("hyper_wait")
    from .hyper import hyper_ewise, hyper_from_coo
    out = A
    for accum, tuples in _runs(A._pending):
        I, J, X = _fold_run_host(tuples, accum, A.type)
        D = hyper_from_coo(I, J, X, A.nrows, A.ncols, type=A.type,
                           dup=None, device=A.device)
        out = hyper_ewise(_merge_op(accum, A.type), out, D, union=True,
                          ztype=A.type)
    out._options.update(public_options(A._options))
    return out


def csr_resize(A, nrows_new: int, ncols_new: int):
    """GxB_Matrix_resize on CSR: entries outside the new frame are
    pruned, the rest remap on device (``GB_resize.c``)."""
    from .assign import _map_compact
    A = A.wait()
    row_map = np.full(A.nrows + 1, -1, np.int64)
    upto = min(A.nrows, nrows_new)
    row_map[:upto] = np.arange(upto)
    col_map = np.full(A.ncols + 1, -1, np.int64)
    upto = min(A.ncols, ncols_new)
    col_map[:upto] = np.arange(upto)
    return _map_compact(A, row_map, col_map, nrows_new, ncols_new)


def hyper_resize(A, nrows_new: int, ncols_new: int):
    """Resize on the hypersparse container: a tuple filter on the device
    (dimension-sized index maps are impossible at 2^60); the kept pairs
    stay sorted."""
    from .hyper import _assemble
    A = A.wait()
    n = A.nvals
    I, J = A.rowids[:n], A.indices[:n]
    keep = (I < nrows_new) & (J < ncols_new)
    return _assemble(I[keep], J[keep],
                     tree_map(lambda v: v[:n][keep], A.values), nrows_new,
                     ncols_new, A.type)
