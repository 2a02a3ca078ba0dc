"""Distributed GraphBLAS operations over a rank mesh: bitmap blocks.

Counterpart of ``graphblas_tpu/parallel/dist.py``.  Matrices are
row-block-sharded over the mesh's "i" axis (or block-sharded over
("i", "j")), each rank holding its block of the bitmap values and
pattern, zero-padded so that every block has one shape:

* **dist_vxm** — w = u ⊕.⊗ A: each rank multiplies its row block by the
  matching u block, then one monoid combine over "i" joins the partials
  (the frontier exchange of BFS/PageRank);
* **dist_mxm** — C<M> = A ⊕.⊗ B with A, C, M row-sharded and B gathered
  on every rank (one ``all_gather`` of B's blocks);
* **dist_mxm_bshard** — the same with B kept row-sharded: d steps, each
  broadcasting one B row block along "i";
* **dist_mxm_summa** — 2-D SUMMA over an ("i", "j") mesh: k steps of
  one A block broadcast along "j" and one B block along "i" on a square
  mesh, one panel gather per axis otherwise.

The local products are the port's ``semiring_mm``, so an FP32
``min_plus`` product of CUDA blocks runs the tropical kernel on every
rank.  The ranks are processes (:mod:`.mesh`): each calls the same
operation with the same arguments, and ``distribute`` keeps each rank's
block of a container every rank holds.  ``collect`` gathers the blocks
back into a ``Matrix``/``Vector`` on every rank.

The monoid combine across ranks follows the port's fold rules, not the
JAX package's ``pmax``/``pmin`` of the values: LOR/LAND reduce
``x != 0`` (1 where any / every term is nonzero); float MIN/MAX put the
identity in place of NaN first (a NaN term drops out, as in every port
engine); unsigned MIN/MAX compare in the type's order (the keys of
``core.types.ordered``); integer PLUS/TIMES run in int64 and wrap back
(congruent); complex MIN/MAX, TIMES, struct values and every other
monoid gather the partials and fold them with ``Monoid.reduce``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.matrix import Matrix, Vector
from ..core.semirings import Semiring
from ..core.types import (cast_result, from_ordered, ordered, tree_where,
                          zeros_like_typed)
from ..ops.mxm import semiring_mm
from ..utils.tree import tree_map
from . import comm, introspect
from .mesh import Mesh, P, make_mesh, pad_to_multiple

__all__ = ["DistMatrix", "DistVector", "dist_vxm", "dist_mxm",
           "dist_mxm_bshard", "dist_mxm_summa", "distribute",
           "collect"]


def _spec(spec, ndim: int) -> tuple:
    s = tuple(spec) + (None,) * (ndim - len(spec))
    return s[:ndim]


def _block_of(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of a full (padded) tensor."""
    sl = []
    for dim, a in enumerate(_spec(spec, x.dim())):
        if a is None:
            sl.append(slice(None))
            continue
        b = x.shape[dim] // mesh.shape[a]
        c = mesh.coord(a)
        sl.append(slice(c * b, (c + 1) * b))
    return x[tuple(sl)].clone()


def _gather_blocks(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """Every rank's block of a sharded tensor, assembled into the full
    (padded) tensor on every rank."""
    spec = _spec(spec, x.dim())
    if all(a is None for a in spec):
        return x
    g = comm.all_gather(x, mesh, None)
    nb = [mesh.shape[a] if a else 1 for a in spec]
    out = x.new_empty(tuple(s * n for s, n in zip(x.shape, nb)))
    for r in range(mesh.size):
        c = mesh.coords_of(r)
        out[tuple(slice(c[a] * s, (c[a] + 1) * s) if a else slice(None)
                  for a, s in zip(spec, x.shape))] = g[r]
    return out


class DistMatrix:
    """A row-block-sharded bitmap matrix (blocks over ("i", "j") on a
    2-D mesh): ``values`` and ``pattern`` are this rank's block, padded
    so that every block has one shape; ``nrows``/``ncols`` are the
    logical shape."""

    def __init__(self, values, pattern, type, mesh: Mesh, nrows: int,
                 ncols: int, spec: P = P("i", None)):
        self.values = values
        self.pattern = pattern
        self.type = type
        self.mesh = mesh
        self.nrows = nrows
        self.ncols = ncols
        self.spec = P(*_spec(spec, 2))

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def to_matrix(self) -> Matrix:
        """The whole matrix on every rank (one gather of the blocks)."""
        vals = tree_map(lambda a: _gather_blocks(a, self.mesh, self.spec)[
            :self.nrows, :self.ncols], self.values)
        pat = _gather_blocks(self.pattern, self.mesh, self.spec)
        return Matrix(vals, pat[:self.nrows, :self.ncols], self.type)


class DistVector:
    """A vector replicated on every rank (``P(None)``) or sharded over
    "i" (``P("i")``: ``values``/``pattern`` are this rank's block)."""

    def __init__(self, values, pattern, type, mesh: Mesh, size: int,
                 spec: P = P(None)):
        self.values = values
        self.pattern = pattern
        self.type = type
        self.mesh = mesh
        self.size = size
        self.spec = P(*_spec(spec, 1))

    def to_vector(self) -> Vector:
        vals = tree_map(lambda a: _gather_blocks(a, self.mesh, self.spec)[
            :self.size], self.values)
        pat = _gather_blocks(self.pattern, self.mesh, self.spec)
        return Vector(vals, pat[:self.size], self.type)


def distribute(A, mesh: Optional[Mesh] = None,
               spec: Optional[P] = None, square: bool = False):
    """Keep this rank's block of a Matrix/Vector that every rank holds
    (row blocks by default, ("i", "j") blocks on a 2-D mesh),
    zero-padded so that every rank gets an equal block.  ``square=True``
    pads both dims to the same size (for square-iteration algorithms
    where the output vector feeds back as the next frontier)."""
    mesh = mesh or make_mesh()
    dev = mesh.device
    A = A.wait()
    if isinstance(A, Vector):
        n = pad_to_multiple(A.size, mesh.size)
        pad = n - A.size
        spec = spec or P(None)
        vals = tree_map(lambda a: _block_of(torch.nn.functional.pad(
            a.to(dev), (0, pad)), mesh, spec), A.values)
        pat = _block_of(torch.nn.functional.pad(A.pattern.to(dev),
                                                (0, pad)), mesh, spec)
        return DistVector(vals, pat, A.type, mesh, A.size, spec)
    axes = mesh.devices.shape
    di = axes[0]
    dj = axes[1] if len(axes) > 1 else 1
    if square:
        t = pad_to_multiple(max(A.nrows, A.ncols), int(np.lcm(di, dj)))
        m = n = t
    else:
        m = pad_to_multiple(A.nrows, di)
        n = pad_to_multiple(A.ncols, dj)
    padm, padn = m - A.nrows, n - A.ncols
    spec = spec or (P("i", "j") if len(axes) > 1 else P("i", None))

    def shard(a):
        return _block_of(torch.nn.functional.pad(a.to(dev), (0, padn, 0,
                                                             padm)),
                         mesh, spec)
    return DistMatrix(tree_map(shard, A.values), shard(A.pattern), A.type,
                      mesh, A.nrows, A.ncols, spec)


def collect(D):
    """Gather a distributed object back into a single-device
    Matrix/Vector on every rank."""
    return D.to_matrix() if isinstance(D, DistMatrix) else D.to_vector()


# ---------------------------------------------------------------------------
# the monoid combine across ranks
# ---------------------------------------------------------------------------

_ON_COLLECTIVES = ("PLUS", "TIMES", "MIN", "MAX", "LOR", "LAND", "LXOR")


def _monoid_psum(mon, x, mesh: Mesh, axis: Optional[str] = "i"):
    """Fold the ranks' partials ``x`` (values of ``mon``'s type, one
    shape on every rank) with the monoid, by the port's fold rules (see
    the module docstring); every rank gets the result."""
    t = mon.type
    nm = mon.op.name
    if (t.is_udt or nm not in _ON_COLLECTIVES
            or (t.is_complex and nm != "PLUS")):
        g = tree_map(lambda v: comm.all_gather(v, mesh, axis), x)
        return cast_result(mon.reduce(g, axis=0), t)
    if t.is_bool:
        if nm in ("PLUS", "MAX", "LOR"):
            return comm.pmax(x, mesh, axis)
        if nm in ("TIMES", "MIN", "LAND"):
            return comm.pmin(x, mesh, axis)
        return comm.psum(x.to(torch.int32), mesh, axis) % 2 != 0
    if nm in ("LOR", "LAND"):
        red = comm.pmax if nm == "LOR" else comm.pmin
        return red(x != 0, mesh, axis).to(x.dtype)
    if nm == "LXOR":
        return (comm.psum((x != 0).to(torch.int32), mesh, axis) % 2
                != 0).to(x.dtype)
    if nm in ("PLUS", "TIMES"):
        red = comm.psum if nm == "PLUS" else comm.pprod
        if t.is_integer:
            return red(x.to(torch.int64), mesh, axis).to(x.dtype)
        return red(x, mesh, axis)
    if t.is_float:
        x = torch.where(torch.isnan(x), torch.full(
            (), mon.identity_value(), dtype=x.dtype, device=x.device), x)
    red = comm.pmax if nm == "MAX" else comm.pmin
    return from_ordered(red(ordered(x, t), mesh, axis), t)


def _row_block(D, n: int):
    """(this rank's block of a vector sharded like A's rows: values,
    pattern) for a DistVector replicated or sharded over "i"."""
    if D.spec[0] == "i":
        return D.values, D.pattern
    c = D.mesh.coord("i")

    def part(a):
        a = torch.nn.functional.pad(a, (0, max(0, n * D.mesh.shape["i"]
                                               - a.shape[0])))
        return a[c * n:(c + 1) * n]
    return tree_map(part, D.values), part(D.pattern)


# ---------------------------------------------------------------------------
# distributed SpMV:  w = u *.sr A   (u's blocks match A's row blocks)
# ---------------------------------------------------------------------------

def dist_vxm(sr: Semiring, u: DistVector, A: DistMatrix) -> DistVector:
    """w = u *.sr A, one monoid combine over the "i" axis.

    u may be sharded over "i" or replicated; the result comes back
    replicated, so the next iteration's frontier is resliced with no
    communication."""
    mesh = A.mesh
    with introspect.record("dist_vxm", u.values, u.pattern, A.values,
                           A.pattern):
        blk = A.pattern.shape[0]
        uv, up = _row_block(u, blk)
        tv, tp_loc, _ = semiring_mm(
            sr, tree_map(lambda a: a[None, :], uv), up[None, :], A.values,
            A.pattern, atype=u.type, btype=A.type)
        # semiring_mm zeroes absent values; refill with the add identity
        # so that ranks without a local contribution cannot poison
        # MIN/MAX/LAND combines (0 is not their identity)
        tv = tree_where(tp_loc, tv, sr.add.identity_array((), mesh.device))
        tp = comm.pmax(tp_loc, mesh, "i")
        tv = _monoid_psum(sr.add, tv, mesh, "i")
        tv = tree_where(tp, tv, zeros_like_typed((), sr.ztype, mesh.device))
    return DistVector(tree_map(lambda a: a[0], tv), tp[0], sr.ztype, mesh,
                      A.ncols, P(None))


# ---------------------------------------------------------------------------
# distributed masked mxm:  C<M> = A *.sr B   (A row-sharded, B gathered)
# ---------------------------------------------------------------------------

def _effective_mask(M: Optional[DistMatrix], shape, complement: bool,
                    structural: bool, device) -> torch.Tensor:
    """The mask's block as bool (pattern & value by default, pattern
    only when ``structural`` or for a struct-valued M), complemented on
    request; all true without a mask."""
    if M is None:
        return torch.full(shape, not complement, dtype=torch.bool,
                          device=device)
    em = M.pattern
    if not (structural or M.type.is_udt):
        em = em & (M.values != 0)
    em = em[:shape[0], :shape[1]]
    return ~em if complement else em


def _masked(sr: Semiring, tv, tp, emask):
    tp = tp & emask
    return tree_where(tp, tv, zeros_like_typed((), sr.ztype, tp.device)), tp


def _inner(A: DistMatrix, Bv, Bp, k: int):
    """A's block and B trimmed to the logical inner dimension ``k``
    (padding is zero and absent, so the product is unchanged)."""
    return (tree_map(lambda a: a[:, :k], A.values), A.pattern[:, :k],
            tree_map(lambda b: b[:k], Bv), Bp[:k])


def dist_mxm(sr: Semiring, A: DistMatrix, B: DistMatrix,
             M: Optional[DistMatrix] = None, complement: bool = False,
             structural: bool = False) -> DistMatrix:
    """C<M> = A *.sr B with row-sharded A/M/C; B (row-sharded or
    replicated) is gathered once.

    The effective mask (pattern & value by default, pattern only with
    ``structural=True``, as on one device) applies to each rank's block
    product."""
    mesh = A.mesh
    with introspect.record("dist_mxm", A.values, A.pattern, B.values,
                           B.pattern, *(() if M is None else (M.pattern,))):
        Bv = tree_map(lambda b: _gather_blocks(b, mesh, B.spec), B.values)
        Bp = _gather_blocks(B.pattern, mesh, B.spec)
        Av, Ap, Bv, Bp = _inner(A, Bv, Bp, A.ncols)
        tv, tp, _ = semiring_mm(sr, Av, Ap, Bv, Bp, atype=A.type,
                                btype=B.type)
        emask = _effective_mask(M, tuple(tp.shape), complement, structural,
                                tp.device)
        tv, tp = _masked(sr, tv, tp, emask)
    return DistMatrix(tv, tp, sr.ztype, mesh, A.nrows, B.ncols, A.spec)


def _acc_combine(sr: Semiring, cv, cp, tv, tp):
    """Monoid-combine two (values, pattern) partials elementwise."""
    both = cp & tp
    sv = cast_result(sr.add.op(cv, tv), sr.ztype)
    nv = tree_map(lambda s, t, c: torch.where(both, s, torch.where(tp, t, c)),
                  sv, tv, cv)
    return nv, cp | tp


def dist_mxm_bshard(sr: Semiring, A: DistMatrix, B: DistMatrix,
                    M: Optional[DistMatrix] = None,
                    complement: bool = False,
                    structural: bool = False) -> DistMatrix:
    """C<M> = A *.sr B with A, B and M all row-sharded: B is never
    gathered whole; at step k the rank holding B's row block k
    broadcasts it along "i" and every rank multiplies it by the matching
    column slice of its A block.  Use when B does not fit on each rank."""
    mesh = A.mesh
    d = mesh.shape["i"]
    with introspect.record("dist_mxm_bshard", A.values, A.pattern,
                           B.values, B.pattern,
                           *(() if M is None else (M.pattern,))):
        kblk = B.pattern.shape[0]
        m = A.pattern.shape[0]
        n = B.pattern.shape[1]
        padk = kblk * d - A.pattern.shape[1]
        Av = tree_map(lambda a: torch.nn.functional.pad(a, (0, padk)),
                      A.values)
        Ap = torch.nn.functional.pad(A.pattern, (0, padk))
        cv = zeros_like_typed((m, n), sr.ztype, mesh.device)
        cp = torch.zeros((m, n), dtype=torch.bool, device=mesh.device)
        for k in range(d):
            Bkv = tree_map(lambda b: comm.broadcast(b, mesh, "i", k),
                           B.values)
            Bkp = comm.broadcast(B.pattern, mesh, "i", k)
            sl = slice(k * kblk, (k + 1) * kblk)
            tv, tp, _ = semiring_mm(
                sr, tree_map(lambda a: a[:, sl], Av), Ap[:, sl], Bkv, Bkp,
                atype=A.type, btype=B.type)
            cv, cp = _acc_combine(sr, cv, cp, tv, tp)
        emask = _effective_mask(M, (m, n), complement, structural,
                                mesh.device)
        cv, cp = _masked(sr, cv, cp, emask)
    return DistMatrix(cv, cp, sr.ztype, mesh, A.nrows, B.ncols, A.spec)


# ---------------------------------------------------------------------------
# 2-D SUMMA mxm over an ("i","j") mesh
# ---------------------------------------------------------------------------

def dist_mxm_summa(sr: Semiring, A: DistMatrix, B: DistMatrix
                   ) -> DistMatrix:
    """C = A *.sr B on a 2-D ("i","j") mesh, A and B in ("i", "j")
    blocks.

    Square meshes run the k-step SUMMA pipeline: at step k the (i, k)
    block of A is broadcast along "j" and the (k, j) block of B along
    "i", and each rank folds one block product into its C block (live
    memory O(n²/d) a rank).  Other meshes gather A's row panel along
    "j" and B's column panel along "i" once (O(n²/√d))."""
    mesh = A.mesh
    pi, pj = mesh.shape["i"], mesh.shape["j"]
    with introspect.record("dist_mxm_summa", A.values, A.pattern,
                           B.values, B.pattern):
        if pi == pj:
            m = A.pattern.shape[0]
            n = B.pattern.shape[1]
            cv = zeros_like_typed((m, n), sr.ztype, mesh.device)
            cp = torch.zeros((m, n), dtype=torch.bool, device=mesh.device)
            for k in range(pi):
                Akv = tree_map(lambda a: comm.broadcast(a, mesh, "j", k),
                               A.values)
                Akp = comm.broadcast(A.pattern, mesh, "j", k)
                Bkv = tree_map(lambda b: comm.broadcast(b, mesh, "i", k),
                               B.values)
                Bkp = comm.broadcast(B.pattern, mesh, "i", k)
                tv, tp, _ = semiring_mm(sr, Akv, Akp, Bkv, Bkp,
                                        atype=A.type, btype=B.type)
                cv, cp = _acc_combine(sr, cv, cp, tv, tp)
        else:
            def panel(x, axis, dim):
                g = comm.all_gather(x, mesh, axis)
                return torch.cat(list(g), dim=dim)
            k = A.ncols
            Av = tree_map(lambda a: panel(a, "j", 1)[:, :k], A.values)
            Ap = panel(A.pattern, "j", 1)[:, :k]
            Bv = tree_map(lambda b: panel(b, "i", 0)[:k], B.values)
            Bp = panel(B.pattern, "i", 0)[:k]
            cv, cp, _ = semiring_mm(sr, Av, Ap, Bv, Bp, atype=A.type,
                                    btype=B.type)
    return DistMatrix(cv, cp, sr.ztype, mesh, A.nrows, B.ncols, P("i", "j"))
