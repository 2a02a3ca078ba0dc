"""Start a world of ranks on this host and run one function in each.

The JAX package's tests run its distributed layer on 8 virtual CPU
devices of one process; here every rank is a process.  ``run_world``
spawns ``world`` processes (``torch.multiprocessing.spawn``), joins them
through a ``file://`` store in a fresh temporary directory (so that
worlds started side by side never meet on a port), runs ``fn(rank,
*args)`` in each, and returns rank 0's result.  An exception in any rank
ends the world (the other ranks are stopped) and is raised again in the
caller with the rank's traceback.

``fn`` must be importable by name in a fresh process (a module-level
function), and its arguments and rank 0's result picklable; the ranks
import only what ``fn``'s module imports.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_world"]

#: how long a rank waits in one collective for the others
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               tmp: str, args: tuple) -> None:
    bind = {}
    if torch.device(device).type == "cuda":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            bind["device_id"] = card
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT, **bind)
    try:
        out = fn(rank, *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, backend: str, device, *args):
    """Run ``fn(rank, *args)`` on ``world`` ranks joined over
    ``backend`` ("nccl" or "gloo"), each rank on ``device`` ("cpu", or
    "cuda": rank r on card r % device_count); return rank 0's result.

    NCCL takes one GPU per rank and raises here if there are fewer; a
    gloo world may put several ranks on one card."""
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend carries CUDA tensors only")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"nccl needs one GPU per rank: {world} ranks, "
                f"{torch.cuda.device_count()} GPUs; name gloo to run "
                f"several ranks on one card")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\"")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world, backend, str(dev), tmp, args),
                 nprocs=world, join=True)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
