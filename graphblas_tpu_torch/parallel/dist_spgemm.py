"""Sharded-CSR SpGEMM: B slabs rotate around the ring of ranks.

Counterpart of ``graphblas_tpu/parallel/dist_spgemm.py``.
C<M> = A *.sr* B with A, B and M row-slabbed over a 1-D mesh at
O(nnz/d) a rank.  At each of the d steps every rank forms the partial
products of its A slab against the B slab it holds, folds them into its
mask-aligned accumulator with the add monoid, and passes the B slab to
the next rank (``comm.ppermute``: all sends and receives posted
together): the systolic SpGEMM, each step's work the lane expansion and
mask search of the single-device counting engine.  The monoid is
associative and commutative, so the folds across steps commute with
the folds within one.

Host plan (every rank computes it alike from the inputs every rank
holds): B's rows are cut into slabs of equal flop weight
(``_balanced_boundaries``: every ring step is a barrier, so a hub slab
would cost d times its weight), and each rank's A entries are sorted by
the contraction index k, with offsets bounding the entries that meet
each B slab (``_ksorted_slabs``), so that a step touches only those.

Every add monoid folds by the port's segment reductions
(``sparse.spmv.segment_fold``): the named ones scatter (PLUS, TIMES,
MIN/MAX with NaN terms dropped and unsigned order kept, LOR/LAND by the
op's rule on every type, LXOR/EQ), any other sorts the step's lanes by
target and runs the segmented scan.  The JAX package's scatter folds
take LOR/LAND as max/min of the values on non-bool types.

``dist_spgemm`` is the unmasked form: each rank keeps its product lanes
(the host counts them first and refuses more than
``max_lanes_per_dev``), then one local sort and fold gives its rows.

Each call returns the whole product as a CsrMatrix on every rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.errors import DimensionMismatch
from ..core.matrix import Matrix, device_values, host_values
from ..core.semirings import Semiring
from ..core.types import Type, cast, cast_result
from ..sparse.container import CsrMatrix, csr_from_coo
from ..sparse.esc import _bucket
from ..sparse.spmv import segment_fold
from ..sparse.tri import csr_filter_lanes, csr_tril
from ..utils.tree import tree_flatten, tree_map, tree_unflatten
from . import comm, introspect
from .dist_csr import _slab_from_tuples, _tuples
from .mesh import Mesh, make_mesh, pad_to_multiple

__all__ = ["dist_masked_spgemm", "dist_spgemm", "dist_tricount_csr"]


def _as_csr(A) -> CsrMatrix:
    if isinstance(A, CsrMatrix):
        return A.wait()
    if isinstance(A, Matrix):
        return CsrMatrix.from_matrix(A.wait())
    return A.wait()


def _check_dims(A, B, M=None):
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise DimensionMismatch(f"inner dims {A.shape} x {B.shape}")
    if M is not None and M.shape != (m, n):
        raise DimensionMismatch(f"mask {M.shape} vs product {(m, n)}")
    return m, k, n


def _balanced_boundaries(w: np.ndarray, d: int, npad: int) -> np.ndarray:
    """Cut [0, len(w)) into d contiguous slabs of about equal total
    weight (the flop-balanced slicing the reference planned in
    ``GB_AxB_parallel.c:52-59``).  Returns int64 boundaries of length
    d+1 with bnd[-1] = npad."""
    cs = np.concatenate([[0], np.cumsum(w, dtype=np.float64)])
    total = cs[-1]
    if total <= 0:
        bnd = np.linspace(0, npad, d + 1).astype(np.int64)
        bnd[0], bnd[-1] = 0, npad
        return bnd
    bnd = np.searchsorted(cs, total * np.arange(d + 1) / d)
    bnd = np.minimum(bnd, len(w)).astype(np.int64)
    bnd[0] = 0
    bnd[-1] = npad
    return np.maximum.accumulate(bnd)


def _ksorted_slabs(I, J, X, t: Type, p: int, d: int, blkA: int,
                   bndB: np.ndarray, degB: np.ndarray, device):
    """Rank p's ring plan from A's host tuples (I, J, X) of type ``t``:
    its A entries sorted by the contraction column k (then row), the
    offsets ``offs[s]:offs[s+1]`` of the entries whose k lies in B slab
    s, and the most lanes one step forms.  Returns (a_idx, a_loc, a_val,
    offs, max_step_flops)."""
    sel = (I // blkA) == p
    I, J = I[sel], J[sel]
    order = np.lexsort((I, J))
    I, J = I[order], J[order]
    X = tree_map(lambda v: np.asarray(v)[sel][order], X)
    slab = np.minimum(np.searchsorted(bndB[1:], J, side="right"), d - 1)
    offs = np.searchsorted(slab, np.arange(d + 1))
    flc = np.concatenate([[0], np.cumsum(degB[J])])
    flops = flc[offs[1:]] - flc[offs[:-1]]
    return (torch.from_numpy(J).to(device),
            torch.from_numpy(I - p * blkA).to(device),
            device_values(X, t, device), offs,
            int(flops.max()) if flops.size else 0)


def _lanes(csum: torch.Tensor, deg: torch.Tensor, lo: int, hi: int):
    """(entry, offset within its B row) of the lanes lo..hi-1 of a step
    whose entries expand to ``deg`` lanes each (``csum`` their inclusive
    prefix sums)."""
    t = torch.arange(lo, hi, dtype=torch.int64, device=csum.device)
    e = torch.searchsorted(csum, t, right=True)
    return e, t - (csum[e] - deg[e])


def _fold(sr: Semiring, acc, tgt: torch.Tensor, z, nslots: int):
    """acc (+)= the lanes z folded into their slots ``tgt`` by the add
    monoid (the generic fold needs its slots sorted)."""
    zt = sr.ztype
    if zt.is_udt or sr.add.op.name not in (
            "PLUS", "TIMES", "MIN", "MAX", "LOR", "LAND", "LXOR", "EQ") \
            or (zt.is_complex and sr.add.op.name == "TIMES"):
        tgt, order = torch.sort(tgt, stable=True)
        z = tree_map(lambda v: v[order], z)
    fresh = segment_fold(sr.add, z, tgt, nslots, zt)
    return cast_result(sr.add.op(acc, fresh), zt)


def _ring_leaves(DB):
    leaves, tree = tree_flatten(DB.values)
    return [DB.rowptr, DB.indices, *leaves], tree


def dist_masked_spgemm(sr: Semiring, A, B, M,
                       mesh: Optional[Mesh] = None,
                       chunk: int = 1 << 18) -> CsrMatrix:
    """C<M> = A *.sr* B over the mesh, A/B/M row-slabbed and B's slabs
    rotated around the ring; the whole C on every rank, its pattern the
    mask entries that received at least one product (GraphBLAS product
    pattern semantics)."""
    mesh = mesh or make_mesh()
    d = mesh.shape["i"]
    p = mesh.coord("i")
    dev = mesh.device
    A, B, M = _as_csr(A), _as_csr(B), _as_csr(M)
    m, k, n = _check_dims(A, B, M)
    zt = sr.ztype
    blkA = pad_to_multiple(max(m, 1), d) // d

    # this rank's mask slab as sorted keys i_loc * n + j
    IM, JM, _ = M.extractTuples()
    slab_of_m = IM // blkA
    cnt_m = np.bincount(slab_of_m, minlength=d)
    sel = slab_of_m == p
    m_keys = torch.from_numpy((IM[sel] - p * blkA) * n + JM[sel]).to(dev)
    nzM = int(sel.sum())

    # the ring plan: B's slabs cut at equal flop weight, A k-sorted
    # (each operand copied to the host once)
    Ia, Ja, Xa = _tuples(A)[:3]
    tB = _tuples(B)
    degB = np.bincount(tB[0], minlength=k).astype(np.int64)
    indegA = np.bincount(Ja, minlength=k)
    bndB = _balanced_boundaries(degB * indegA, d, pad_to_multiple(
        max(k, 1), d))
    DB = _slab_from_tuples(*tB, mesh, boundaries=bndB)
    a_idx, a_loc, a_val, offs, max_fl = _ksorted_slabs(
        Ia, Ja, Xa, A.type, p, d, blkA, bndB, degB, dev)
    chunk = min(chunk, _bucket(max(max_fl, 1 << 12)))
    av = cast(a_val, sr.xtype, A.type) if not zt.is_udt else a_val

    with introspect.record("dist_masked_spgemm", a_idx, a_val, DB.indices,
                           DB.values, m_keys):
        acc = sr.add.identity_array((nzM + 1,), dev)
        npres = torch.zeros(nzM + 1, dtype=torch.int32, device=dev)
        ring, tree = _ring_leaves(DB)
        for s in range(d):
            b_rowptr, b_idx, *b_leaves = ring
            b_val = tree_unflatten(tree, b_leaves)
            slab = (p - s) % d
            lo, hi = int(offs[slab]), int(offs[slab + 1])
            if hi > lo and nzM:
                kk = a_idx[lo:hi] - int(bndB[slab])
                rp = b_rowptr.long()
                deg = rp[kk + 1] - rp[kk]
                csum = torch.cumsum(deg, 0)
                total = int(csum[-1])
                bv = cast(b_val, sr.ytype, B.type) if not zt.is_udt \
                    else b_val
                for c0 in range(0, total, chunk):
                    e, off = _lanes(csum, deg, c0, min(c0 + chunk, total))
                    pos = rp[kk[e]] + off
                    key = a_loc[lo:hi][e] * n + b_idx[pos].long()
                    idx = torch.searchsorted(m_keys, key).clamp(
                        max=nzM - 1)
                    member = m_keys[idx] == key
                    ent = lo + e[member]
                    pm = pos[member]
                    z = cast_result(sr.mult(tree_map(lambda v: v[ent], av),
                                            tree_map(lambda v: v[pm], bv)),
                                    zt)
                    tgt = idx[member]
                    acc = _fold(sr, acc, tgt, z, nzM + 1)
                    npres.index_add_(0, tgt, torch.ones_like(
                        tgt, dtype=torch.int32))
            if s < d - 1:
                ring = comm.ppermute(ring, mesh, "i")

        # assembly: the slabs' folds, in rank order, are M's entries in
        # M's own order; one gather puts them on every rank
        nzpad = pad_to_multiple(max(int(cnt_m.max()), 1), 128)

        def gather(v):
            v = torch.nn.functional.pad(v[:nzM], (0, nzpad - nzM))
            g = comm.all_gather(v, mesh, "i")
            return torch.cat([g[q, :int(cnt_m[q])] for q in range(d)])
        vals = tree_map(gather, acc)
        pres = gather(npres) > 0
    Md = M.indptr.device
    padM = M.nzmax - M.nvals
    vals = tree_map(lambda v: torch.nn.functional.pad(v, (0, padM)).to(Md),
                    vals)
    C = CsrMatrix(M.indptr, M.indices, M.rowids, vals, M.nvals, m, n, zt)
    return csr_filter_lanes(C, torch.nn.functional.pad(pres, (0, padM)).to(
        Md))


def dist_tricount_csr(A, mesh: Optional[Mesh] = None,
                      chunk: int = 1 << 18) -> int:
    """Distributed Sandia triangle count on CSR slabs:
    ntri = reduce(+, (L *.plus_pair* L)<L>) over the mesh."""
    from ..core.semirings import semiring
    from ..core.types import INT32
    L = csr_tril(_as_csr(A))
    with introspect.record("dist_tricount_csr", L.indices, L.values):
        C = dist_masked_spgemm(semiring.plus_pair[INT32], L, L, L,
                               mesh=mesh, chunk=chunk)
    return int(C.values[:C.nvals].to(torch.int64).sum())


# ---------------------------------------------------------------------------
# Unmasked distributed SpGEMM
# ---------------------------------------------------------------------------

def dist_spgemm(sr: Semiring, A, B, mesh: Optional[Mesh] = None,
                chunk: int = 1 << 18,
                max_lanes_per_dev: int = 1 << 27) -> CsrMatrix:
    """Unmasked C = A *.sr* B over the mesh: A/B row-slabbed, B's slabs
    rotated around the ring, each rank's product lanes kept (their
    count planned on the host first, as ``GB_AxB_flopcount`` sizes the
    output), then one local sort and monoid fold gives the rank's rows;
    the whole C on every rank."""
    mesh = mesh or make_mesh()
    d = mesh.shape["i"]
    p = mesh.coord("i")
    dev = mesh.device
    A, B = _as_csr(A), _as_csr(B)
    m, k, n = _check_dims(A, B)
    zt = sr.ztype
    tA, tB = _tuples(A), _tuples(B)
    DA = _slab_from_tuples(*tA, mesh)
    DB = _slab_from_tuples(*tB, mesh)
    blkA, blkB = DA.blk, DB.blk

    # lanes each rank forms, from the host patterns
    Ia, Ja = tA[:2]
    degB = np.bincount(tB[0], minlength=k + 1)
    flops = np.zeros((d, d), np.int64)
    np.add.at(flops, (Ia // blkA, np.minimum(Ja // blkB, d - 1)), degB[Ja])
    lanes = int(flops.sum(1).max())
    if lanes > max_lanes_per_dev:
        raise MemoryError(
            f"unmasked distributed SpGEMM needs {lanes} lanes on a rank "
            f"(cap {max_lanes_per_dev}); use dist_masked_spgemm or more "
            f"ranks")

    live = DA.locrow < DA.blk
    a_idx = DA.indices[live].long()
    a_loc = DA.locrow[live].long()
    av = DA.values if zt.is_udt else cast(DA.values, sr.xtype, A.type)
    av = tree_map(lambda v: v[live], av)
    with introspect.record("dist_spgemm", DA.indices, DA.values,
                           DB.indices, DB.values):
        keys, zs = [], []
        ring, tree = _ring_leaves(DB)
        for s in range(d):
            b_rowptr, b_idx, *b_leaves = ring
            b_val = tree_unflatten(tree, b_leaves)
            bv = b_val if zt.is_udt else cast(b_val, sr.ytype, B.type)
            base = ((p - s) % d) * blkB
            inb = (a_idx >= base) & (a_idx < base + blkB)
            ent = torch.nonzero(inb)[:, 0]
            if ent.numel():
                kk = a_idx[ent] - base
                rp = b_rowptr.long()
                deg = rp[kk + 1] - rp[kk]
                csum = torch.cumsum(deg, 0)
                total = int(csum[-1])
                for c0 in range(0, total, chunk):
                    e, off = _lanes(csum, deg, c0, min(c0 + chunk, total))
                    pos = rp[kk[e]] + off
                    keys.append(a_loc[ent[e]] * n + b_idx[pos].long())
                    zs.append(cast_result(sr.mult(
                        tree_map(lambda v: v[ent[e]], av),
                        tree_map(lambda v: v[pos], bv)), zt))
            if s < d - 1:
                ring = comm.ppermute(ring, mesh, "i")

        # local ESC: sort the lanes by key, fold the duplicates
        if keys:
            key = torch.cat(keys)
            z = tree_map(lambda *vs: torch.cat(vs), *zs)
        else:
            key = torch.zeros(0, dtype=torch.int64, device=dev)
            z = sr.add.identity_array((0,), dev)
        key, order = torch.sort(key, stable=True)
        z = tree_map(lambda v: v[order], z)
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        seg = torch.cumsum(first, 0) - 1
        nu = int(first.sum())
        folded = segment_fold(sr.add, z, seg, nu, zt)
        kuniq = key[first]

        # every rank's rows, on every rank
        cnt = comm.all_gather(torch.tensor([nu], device=dev), mesh, "i")
        cnt = cnt.reshape(-1).cpu().numpy()
        cap = pad_to_multiple(max(int(cnt.max()), 1), 128)

        def gather(v):
            g = comm.all_gather(torch.nn.functional.pad(v, (0, cap - nu)),
                                mesh, "i")
            return torch.cat([g[q, :int(cnt[q])] for q in range(d)])
        gk = gather(kuniq).cpu().numpy()
        row0 = np.repeat(np.arange(d, dtype=np.int64) * blkA, cnt)
        X = tree_map(lambda v: gather(v), folded)
    return csr_from_coo(gk // n + row0, gk % n, host_values(X, zt), m, n,
                        type=zt, sum_duplicates=False, device=dev)
