"""Distributed demo (``demos/dist_demo.py``): BFS, PageRank and triangle
counting over a mesh of ranks, one collective a level or an iteration,
each checked against the single-device model.

Usage: python -m graphblas_tpu_torch.demos.dist [--device DEV]
       [--world N] [--backend nccl|gloo]

On the card: one rank per visible GPU over NCCL by default; ``--world 4
--backend gloo`` puts four ranks on one card.  ``--device cpu``: four
ranks over gloo on the CPU.
"""
import numpy as np

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import models, parallel as par
from graphblas_tpu_torch.demos._common import world_args


def rank_main(rank, world, device):
    mesh = par.make_mesh(device=device)

    def say(msg):
        if rank == 0:
            print(msg, flush=True)
    say(f"ranks: {world} x {mesh.backend} on {mesh.device.type}")
    pat = models.wathen_pattern(6, 6)
    np.fill_diagonal(pat, False)
    A = gt.Matrix.from_dense(pat, gt.BOOL, pattern=pat, device=mesh.device)
    n = A.nrows
    say(f"graph: {n} nodes, {int(pat.sum())//2} edges, "
        f"mesh {mesh.devices.shape}")

    lev = par.dist_bfs(A, 0, mesh)
    say(f"dist_bfs: {int((lev != 0).sum())} reachable, "
        f"max level {int(lev.max())}")
    assert np.array_equal(lev, models.bfs_jit(A, 0))

    r = par.dist_pagerank(A, iters=20, mesh=mesh)
    say(f"dist_pagerank: top node {int(np.argmax(r))} "
        f"rank {r.max():.6f}")

    ntri = par.dist_tricount(A, mesh)
    want = int(((pat.astype(np.float64) @ pat) * pat).sum()) // 6
    say(f"dist_tricount: {ntri} triangles")
    assert ntri == want
    say("dist_demo OK")


def main(argv=None):
    device, world, backend, _ = world_args(argv)
    # the ranks find rank_main by its module's import name
    from graphblas_tpu_torch.demos import dist as this
    par.run_world(this.rank_main, world, backend, device, world, device)


if __name__ == "__main__":
    main()
