"""What every demo shares: the ``--device`` option."""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple


def demo_args(argv: Optional[List[str]] = None) -> Tuple[object, List[str]]:
    """(device, the other arguments) of a demo's command line: ``--device
    DEV`` (or ``--device=DEV``) may stand anywhere; without it the
    device is None, which means the card."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    rest = []
    k = 0
    while k < len(args):
        a = args[k]
        if a == "--device":
            if k + 1 == len(args):
                raise SystemExit("--device needs a value, such as cpu")
            device = args[k + 1]
            k += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        k += 1
    return device, rest


def world_args(argv: Optional[List[str]] = None):
    """(device, world, backend, the other arguments) of a distributed
    demo: ``--device`` as for every demo, ``--world N`` ranks and
    ``--backend nccl|gloo``.  On the card (no ``--device``) the default
    is one rank per visible GPU over NCCL; with ``--device cpu`` four
    ranks over gloo."""
    import argparse
    import torch
    from graphblas_tpu_torch.sparse.container import resolve_device
    device, rest = demo_args(argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--world", type=int)
    ap.add_argument("--backend")
    opts, args = ap.parse_known_args(rest)
    dev = resolve_device(device)
    cpu = dev.type == "cpu"
    world = opts.world or (4 if cpu else torch.cuda.device_count())
    backend = opts.backend or ("gloo" if cpu else "nccl")
    return str(dev), world, backend, args
