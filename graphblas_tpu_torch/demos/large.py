"""Large-graph demo (``demos/large_demo.py``): SpMV and BFS on an R-MAT
power-law graph through the sharded-CSR path: no dense intermediate
anywhere, the scale the bitmap containers cannot reach.

Usage: python -m graphblas_tpu_torch.demos.large [--device DEV]
       [--world N] [--backend nccl|gloo] [scale] [edge_factor]
       (default scale 15: 32 K nodes, about 1 M directed edges)

The single-device SpMV runs on rank 0; every rank holds the graph and
its slab of the BFS.  Ranks and backends as in ``demos/dist.py``.
"""
import time

import numpy as np
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import parallel as par
from graphblas_tpu_torch.demos._common import world_args


def host_bfs(indptr, indices, n, src):
    lev = np.zeros(n, np.int64)
    frontier = np.array([src])
    lev[src] = 1
    level = 2
    while len(frontier):
        nxt = np.unique(np.concatenate(
            [indices[indptr[v]:indptr[v + 1]] for v in frontier]))
        nxt = nxt[lev[nxt] == 0]
        lev[nxt] = level
        frontier = nxt
        level += 1
    return lev


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_main(rank, device, scale, ef):
    mesh = par.make_mesh(device=device)
    dev = mesh.device

    def say(msg):
        if rank == 0:
            print(msg, flush=True)
    n = 1 << scale
    t0 = time.perf_counter()
    I, J = gt.rmat_edges(scale, ef, seed=7)
    say(f"rmat scale={scale}: {n} nodes, {len(I)} directed edges "
        f"({time.perf_counter()-t0:.2f}s gen)")

    t0 = time.perf_counter()
    A = gt.csr_from_coo(I, J, np.ones(len(I), np.float32), n, n,
                        type=gt.FP32, sum_duplicates=False, device=dev)
    say(f"csr build: {time.perf_counter()-t0:.2f}s (nzmax {A.nzmax})")

    if rank == 0:
        # device SpMV rate, then the result against a host oracle on a
        # sample of rows
        x = np.random.default_rng(0).random(n).astype(np.float32)
        sr = gt.semiring.plus_times[gt.FP32]
        xd = torch.from_numpy(x).to(dev)
        y, _ = gt.csr_mxv(sr, A, xd)
        sync(dev)
        K = 20
        t0 = time.perf_counter()
        for _ in range(K):
            y, _ = gt.csr_mxv(sr, A, xd)
        sync(dev)
        dt = (time.perf_counter() - t0) / K
        say(f"spmv: {dt*1e3:.2f} ms -> {len(I)/dt/1e6:.0f} M nnz/s")
        indptr = A.indptr.cpu().numpy()
        indices = A.indices[:A.nvals].cpu().numpy()
        vals = A.values[:A.nvals].cpu().numpy()
        yh = y.cpu().numpy()
        for r in np.random.default_rng(1).integers(0, n, 64):
            want = (vals[indptr[r]:indptr[r + 1]] *
                    x[indices[indptr[r]:indptr[r + 1]]]).sum()
            assert np.isclose(yh[r], want, rtol=1e-4), r
        say("spmv sample-verified")

    t0 = time.perf_counter()
    lev = par.dist_csr_bfs(A, 0, mesh)
    say(f"bfs: {time.perf_counter()-t0:.2f}s, "
        f"{int((lev != 0).sum())} reachable, {int(lev.max())} levels")
    if rank == 0:
        indptr = A.indptr.cpu().numpy()
        indices = A.indices[:A.nvals].cpu().numpy()
        assert np.array_equal(lev, host_bfs(indptr, indices, n, 0))
    say("bfs verified")
    say("large_demo OK")


def main(argv=None):
    device, world, backend, args = world_args(argv)
    scale = int(args[0]) if args else 15
    ef = int(args[1]) if len(args) > 1 else 16
    from graphblas_tpu_torch.demos import large as this
    par.run_world(this.rank_main, world, backend, device, device, scale, ef)


if __name__ == "__main__":
    main()
