"""The rank side of the distributed layer's parity checks.

Each function here takes its inputs as host arrays and names (so that
they cross to the ranks by pickling), runs one of the layer's calls on
this rank and returns host arrays; the same inputs go through the JAX
package's function elsewhere and the two results are compared there.
:func:`run_cases` runs a list of them in one world, every rank the same
list in the same order, and returns ``{case id: result}`` (an exception
raised alike on every rank is returned as its message under
``"error"``):

    results = run_world(run_cases, 4, "gloo", "cpu", cases, "cpu")

Containers are built with ``device=mesh.device``; a semiring is named
``(family, type name)``, e.g. ``("plus_times", "FP64")``.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

from ..core.matrix import Matrix, Vector, host_values
from ..core.semirings import semiring
from ..core.types import type_by_name
from ..sparse.container import CsrMatrix
from . import introspect
from .algorithms import (bfs_step_sharded, dist_bfs, dist_pagerank,
                         dist_tricount, pagerank_step_sharded)
from .dist import (collect, dist_mxm, dist_mxm_bshard, dist_mxm_summa,
                   dist_vxm, distribute)
from .dist_csr import (dist_csr_bfs, dist_csr_from_matrix, dist_csr_mxv,
                       dist_csr_pagerank)
from .dist_spgemm import dist_masked_spgemm, dist_spgemm, dist_tricount_csr
from .mesh import P, make_mesh

__all__ = ["run_cases", "CASES"]


def _sr(name):
    fam, t = name
    return semiring[fam][type_by_name(t)]


def _dense(X):
    """(values, pattern) of a bitmap container on the host, the values
    in the type's own dtype (a dict of field arrays for a struct)."""
    X = X.wait()
    return host_values(X.values, X.type), X.pattern.cpu().numpy()


def _matrix(meshes, vals, pat, t):
    dev = meshes.device
    return Matrix.from_dense(vals, type_by_name(t), pattern=pat, device=dev)


def _vector(meshes, vals, pat, t):
    return Vector.from_dense(vals, type_by_name(t), pattern=pat,
                             device=meshes.device)


def _csr(meshes, I, J, X, m, n, t, sum_duplicates=True):
    return CsrMatrix.from_coo(I, J, X, m, n, type=type_by_name(t),
                              sum_duplicates=sum_duplicates,
                              device=meshes.device)


class _Meshes:
    """The world's meshes, made once each (every rank in the same
    order)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._made = {}

    def __call__(self, shape=None, axis_names=("i",)):
        key = (shape, tuple(axis_names))
        if key not in self._made:
            self._made[key] = make_mesh(shape=shape, axis_names=axis_names,
                                        device=self.device)
        return self._made[key]


# -- bitmap blocks (test_parallel.py) ---------------------------------------

def roundtrip(meshes, vals, pat, t):
    return _dense(collect(distribute(_matrix(meshes, vals, pat, t),
                                     meshes())))


def vxm(meshes, sr, avals, apat, at, uvals, upat, ut, u_spec="i"):
    A = distribute(_matrix(meshes, avals, apat, at), meshes())
    u = distribute(_vector(meshes, uvals, upat, ut), meshes(),
                   spec=P(u_spec))
    return _dense(collect(dist_vxm(_sr(sr), u, A)))


def mxm(meshes, sr, a, b, m=None, b_spec=None, complement=False,
        structural=False):
    mesh = meshes()
    A = distribute(_matrix(meshes, *a), mesh)
    B = distribute(_matrix(meshes, *b), mesh,
                   spec=None if b_spec is None else P(*b_spec))
    M = None if m is None else distribute(_matrix(meshes, *m), mesh)
    return _dense(collect(dist_mxm(_sr(sr), A, B, M=M, complement=complement,
                                   structural=structural)))


def mxm_bshard(meshes, sr, a, b, m=None):
    mesh = meshes()
    A, B = (distribute(_matrix(meshes, *x), mesh) for x in (a, b))
    M = None if m is None else distribute(_matrix(meshes, *m), mesh)
    return _dense(collect(dist_mxm_bshard(_sr(sr), A, B, M=M)))


def summa(meshes, sr, a, b, shape):
    mesh = meshes(tuple(shape), ("i", "j"))
    A, B = (distribute(_matrix(meshes, *x), mesh) for x in (a, b))
    return _dense(collect(dist_mxm_summa(_sr(sr), A, B)))


def bfs(meshes, pat, s):
    A = _matrix(meshes, pat.astype(np.float64), pat, "FP64")
    return dist_bfs(A, s, meshes())


def pagerank(meshes, pat, iters):
    A = _matrix(meshes, pat.astype(np.float64), pat, "FP64")
    return dist_pagerank(A, iters=iters, mesh=meshes())


def tricount(meshes, pat):
    A = _matrix(meshes, pat.astype(np.float64), pat, "FP64")
    return dist_tricount(A, meshes())


def steps(meshes, pat, cv):
    """One BFS step from vertex 0 and one PageRank step on row blocks."""
    mesh = meshes()
    n = pat.shape[0]
    Ap = distribute(_matrix(meshes, pat.astype(np.float64), pat, "FP64"),
                    mesh).pattern
    v = torch.zeros(n, dtype=torch.int32, device=mesh.device)
    q = torch.zeros(n, dtype=torch.bool, device=mesh.device)
    q[0] = True
    v2, q2 = bfs_step_sharded(mesh)(v, q, Ap, 1)
    C = distribute(_matrix(meshes, cv, np.ones_like(pat), "FP64"), mesh)
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=mesh.device)
    r2 = pagerank_step_sharded(mesh)(C.values, r, torch.tensor(
        0.15 / n, dtype=torch.float64, device=mesh.device))
    return (v2.cpu().numpy(), q2.cpu().numpy(), r2.cpu().numpy())


# -- sharded CSR (test_parallel.py, test_dist_csr.py) ------------------------

def csr_mxv(meshes, a, x, sr=None, bitmap=False):
    if bitmap:
        A = _matrix(meshes, *a)
    else:
        A = _csr(meshes, *a)
    D = dist_csr_from_matrix(A, meshes())
    if sr is None:
        return dist_csr_mxv(D, x).cpu().numpy()
    s = _sr(sr)
    return host_values(dist_csr_mxv(D, x, s), s.ztype)


def csr_pagerank(meshes, pat, iters):
    A = _matrix(meshes, pat.astype(np.float64), pat, "FP64")
    return dist_csr_pagerank(A, iters=iters, mesh=meshes())


def csr_bfs(meshes, pat, s):
    A = _matrix(meshes, pat.astype(np.float64), pat, "FP64")
    return dist_csr_bfs(A, s, meshes())


def masked_spgemm(meshes, sr, a, b, m):
    C = dist_masked_spgemm(_sr(sr), _csr(meshes, *a), _csr(meshes, *b),
                           _csr(meshes, *m), mesh=meshes())
    return C.extractTuples()


def spgemm(meshes, sr, a, b):
    return dist_spgemm(_sr(sr), _csr(meshes, *a), _csr(meshes, *b),
                       mesh=meshes()).extractTuples()


def tricount_csr(meshes, a):
    return dist_tricount_csr(_csr(meshes, *a), meshes())


def _pagerank_flip():
    from ..core.ops import BinaryOp
    from ..core.semirings import semiring_new
    from ..core.types import BOOL
    from ..models.pagerank import PAGERANK_TYPE, pagerank_ops
    pr_mult, _, pr_monoid, _ = pagerank_ops()
    flip = BinaryOp("PR_FLIP", lambda a, x: pr_mult.fn(x, a),
                    PAGERANK_TYPE, BOOL, PAGERANK_TYPE)
    return semiring_new(pr_monoid, flip)


def csr_mxv_udt_vector(meshes, a, rank, invdegree):
    """One PageRank-semiring step (``dpagerank2``'s struct semiring)
    over A' slabs."""
    D = dist_csr_from_matrix(_csr(meshes, *a), meshes())
    y = dist_csr_mxv(D, {"rank": rank, "invdegree": invdegree},
                     _pagerank_flip())
    return {k: v.cpu().numpy() for k, v in y.items()}


def _wt_semiring():
    from ..core.monoids import monoid_new
    from ..core.ops import BinaryOp
    from ..core.semirings import semiring_new
    from ..core.types import FP64, Type
    W = Type.udt("wt", a=FP64, b=FP64)
    mult = BinaryOp("WMULT", lambda e, x: {"a": e["a"] * x,
                                           "b": e["b"] + x}, W, W, FP64)
    add = BinaryOp("WADD", lambda x, y: {
        "a": x["a"] + y["a"], "b": torch.maximum(x["b"], y["b"])}, W, W, W)
    return W, semiring_new(monoid_new(add, {"a": 0.0, "b": -np.inf}), mult)


def csr_udt_matrix_values(meshes, I, J, va, vb, n, x):
    """SpMV with a struct-valued A (fields a, b) and a struct monoid."""
    W, sr = _wt_semiring()
    A = CsrMatrix.from_coo(I, J, {"a": va, "b": vb}, n, n, type=W,
                           sum_duplicates=False, device=meshes.device)
    y = dist_csr_mxv(dist_csr_from_matrix(A, meshes()), x, sr)
    return {k: v.cpu().numpy() for k, v in y.items()}


# -- the census (test_introspect.py) -----------------------------------------

def census(meshes, a):
    """dist_tricount_csr, then one dist_csr_mxv; the census of both and
    the ring's slab bytes as this rank sent them."""
    mesh = meshes()
    A = _csr(meshes, *a)
    ntri = dist_tricount_csr(A, mesh)
    ring = introspect.program_stats("dist_masked_spgemm")
    D = dist_csr_from_matrix(A, mesh)
    y = dist_csr_mxv(D, np.ones(A.nrows, np.float32))
    return {"ntri": ntri, "ring": ring,
            "mxv": introspect.program_stats("dist_csr_mxv"),
            "y": y.cpu().numpy(),
            "none": introspect.program_stats("no_such_program")}


def meshes_and_specs(meshes):
    """The default 1-D and 2-D meshes' shapes and the placement specs;
    a mesh of a size other than the world's raises."""
    from .mesh import replicated, row_sharding
    m1, m2 = meshes(), meshes(axis_names=("i", "j"))
    try:
        make_mesh(m1.size + 1, device=meshes.device)
        wrong = None
    except ValueError as e:
        wrong = str(e)
    return {"shape1": dict(m1.shape), "shape2": dict(m2.shape),
            "devices2": m2.devices.shape, "row": tuple(row_sharding(m1).spec),
            "row3": tuple(row_sharding(m1, 3).spec),
            "rep": tuple(replicated(m2).spec), "wrong": wrong}


def no_card(meshes):
    """make_mesh without ``device`` on a machine without a card."""
    make_mesh()


def dryrun(meshes, n_devices):
    from .dryrun import dryrun_multichip
    return dryrun_multichip(n_devices, device=meshes.device)


CASES = {f.__name__: f for f in (
    roundtrip, vxm, mxm, mxm_bshard, summa, bfs, pagerank, tricount, steps,
    csr_mxv, csr_pagerank, csr_bfs, masked_spgemm, spgemm, tricount_csr,
    csr_mxv_udt_vector, csr_udt_matrix_values, census, meshes_and_specs,
    no_card, dryrun)}


def run_cases(rank: int, cases, device: str):
    """Run ``cases`` (a list of ``(case id, function name, kwargs)``) on
    this rank; rank 0's ``{case id: result}`` comes back from
    ``run_world``."""
    meshes = _Meshes(device)
    out = {}
    for cid, name, kw in cases:
        try:
            out[cid] = CASES[name](meshes, **kw)
        except Exception:       # raised alike on every rank: report it
            out[cid] = {"error": traceback.format_exc()}
    return out
