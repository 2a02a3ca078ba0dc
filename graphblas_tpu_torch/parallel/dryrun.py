"""One distributed step of every kind, on tiny shapes: the counterpart
of ``__graft_entry__.py::dryrun_multichip``.

Every rank calls :func:`dryrun_multichip`; rank 0 prints each step's
line as it completes (the JAX dryrun's lines, word for word, except the
last, which prints this layer's census of the ring SpGEMM in place of
the HLO census).  From the command line it starts its own world:

    python -m graphblas_tpu_torch.parallel.dryrun [--world N]
        [--backend nccl|gloo] [--device cpu]

By default one rank per visible GPU over NCCL; ``--world 4 --backend
gloo`` puts four ranks on one card; ``--device cpu`` runs on the CPU
(gloo, four ranks unless ``--world`` says otherwise).
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip", "demo_graph", "main"]


def demo_graph(n: int = 256, p: float = 0.05, seed: int = 0,
               device=None):
    """The JAX dryrun's graph: a seeded symmetric FP32 pattern, no
    self-edges."""
    import graphblas_tpu_torch as gt
    rng = np.random.default_rng(seed)
    Ap = rng.random((n, n)) < p
    np.fill_diagonal(Ap, False)
    Ap = Ap | Ap.T
    return gt.Matrix.from_dense(Ap.astype(np.float32), gt.FP32, pattern=Ap,
                                device=device)


def dryrun_multichip(n_devices: int, device=None) -> List[str]:
    """Run one distributed step of each kind over a mesh of
    ``n_devices`` ranks (the world): the vxm, a BFS and a PageRank step,
    the dense masked tricount, 2-D SUMMA, the sharded-CSR SpMV (two
    semirings), the ring masked SpGEMM with its tricount, the
    generic-fold and unmasked ring SpGEMMs and the struct SpMV.  Returns
    the lines rank 0 prints."""
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import parallel as par
    from graphblas_tpu_torch.core.ops import BinaryOp
    from graphblas_tpu_torch.core.semirings import semiring, semiring_new
    from graphblas_tpu_torch.models.pagerank import (PAGERANK_TYPE,
                                                     pagerank_ops)
    from graphblas_tpu_torch.parallel import introspect
    lines = []

    def say(msg):
        if dist.get_rank() == 0:
            print(msg, flush=True)
            lines.append(msg)

    mesh = par.make_mesh(n_devices, device=device)
    dev = mesh.device
    n = 8 * n_devices  # tiny but shardable
    A = demo_graph(n=n, p=0.3, seed=1, device=dev)

    # distributed containers + collective SpMV through the public API
    D = par.distribute(A, mesh, square=True)
    u = gt.Vector.from_dense(np.arange(n, dtype=np.float32), device=dev)
    du = par.distribute(u, mesh, spec=par.P("i"))
    w = par.dist_vxm(semiring.plus_times[gt.FP32], du, D)
    w.values.cpu()
    say("dryrun: dist_vxm plus_times ok")

    # one BFS step + one PageRank step on the row blocks
    nn = D.pattern.shape[1]
    v = torch.zeros(nn, dtype=torch.int32, device=dev)
    q = torch.zeros(nn, dtype=torch.bool, device=dev)
    q[0] = True
    par.bfs_step_sharded(mesh)(v, q, D.pattern, 1)
    r = torch.full((nn,), 1.0 / n, dtype=torch.float32, device=dev)
    par.pagerank_step_sharded(mesh)(D.values.to(torch.float32), r,
                                    torch.tensor(0.15 / n, device=dev))
    say("dryrun: BFS step + PageRank step (psum) ok")

    # masked distributed block product (the tricount)
    assert par.dist_tricount(A, mesh) >= 0
    say("dryrun: dist_tricount (masked block SpGEMM) ok")

    # 2-D SUMMA block product
    mesh2 = par.make_mesh(n_devices, axis_names=("i", "j"), device=device)
    DA = par.distribute(A, mesh2)
    DB = par.distribute(A, mesh2)
    C = par.dist_mxm_summa(semiring.plus_times[gt.FP32], DA, DB)
    C.pattern.cpu()
    say("dryrun: 2-D SUMMA ok")

    # memory-scalable sharded-CSR SpMV (segment-reduce slabs)
    Dc = par.dist_csr_from_matrix(A, mesh)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    par.dist_csr_mxv(Dc, ones).cpu()
    # ... and the general-semiring form (min_plus tropical SpMV)
    par.dist_csr_mxv(Dc, ones, semiring.min_plus[gt.FP32]).cpu()
    say("dryrun: sharded-CSR SpMV (plus_times + min_plus) ok")

    # ring-rotating sharded-CSR masked SpGEMM
    Ac = gt.CsrMatrix.from_matrix(A)
    par.dist_masked_spgemm(semiring.plus_times[gt.FP32], Ac, Ac, Ac,
                           mesh).extractTuples()
    assert par.dist_tricount_csr(Ac, mesh) >= 0
    say("dryrun: k-sorted ring masked SpGEMM + tricount_csr ok")

    # the generic-monoid fold (LXOR), the unmasked ring SpGEMM and the
    # struct-valued SpMV
    par.dist_masked_spgemm(semiring.lxor_land[gt.BOOL], Ac, Ac, Ac,
                           mesh).extractTuples()
    par.dist_spgemm(semiring.plus_times[gt.FP32], Ac, Ac,
                    mesh).extractTuples()
    pr_mult, _, pr_monoid, _ = pagerank_ops()
    flip = BinaryOp("PR_FLIP_DRY", lambda a, x: pr_mult.fn(x, a),
                    PAGERANK_TYPE, gt.BOOL, PAGERANK_TYPE)
    sru = semiring_new(pr_monoid, flip)
    I, J, _ = Ac.extractTuples()
    ATb = gt.CsrMatrix.from_coo(J, I, np.ones(len(I), bool), n, n,
                                type=gt.BOOL, device=dev)
    Du = par.dist_csr_from_matrix(ATb, mesh)
    r0 = {"rank": torch.full((n,), 1.0 / n, dtype=torch.float64,
                             device=dev),
          "invdegree": torch.ones(n, dtype=torch.float64, device=dev)}
    par.dist_csr_mxv(Du, r0, sru)["rank"].cpu()
    say("dryrun: LXOR generic-fold ring SpGEMM, unmasked ring "
        "SpGEMM, UDT DistCsr SpMV ok")
    st = introspect.program_stats("dist_masked_spgemm")
    if st is not None:
        say(f"dryrun: ring schedule collectives: {st['collectives']}")
    return lines


def _rank(rank: int, world: int, device: str) -> List[str]:
    return dryrun_multichip(world, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .launch import run_world
    cpu = torch.device(args.device).type == "cpu"
    world = args.world or (4 if cpu else torch.cuda.device_count())
    backend = args.backend or ("gloo" if cpu else "nccl")
    from graphblas_tpu_torch.parallel import dryrun as this
    run_world(this._rank, world, backend, args.device, world, args.device)
    print("dryrun ok")


if __name__ == "__main__":
    main()
