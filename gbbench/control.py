"""The control of a cell's correctness check, at the cell's own size:
the plain reference put in the program's place, computed one precision
below (the count's running total in bfloat16, the product in TF32, the
BFS's frontier counts in int8), judged by the same comparison.  It must
come out as not correct on every seed.  The program is not run.

    python3 gbbench/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line a seed: the numbers compared and each limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell: dict, seed: int, device, cfg: dict = None) -> dict:
    from gbbench import harness
    cfg = cfg or harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    entry = harness.load_module("entries", traffic["entry"])
    ref = harness.load_module("reference", traffic["entry"])
    graph = harness.load_module("graphs", cfg["graph"]).make(cfg, seed,
                                                             device)
    inputs = entry.make_inputs(graph, cfg, traffic, seed, device)
    numbers = ref.control_numbers(inputs)
    fails = any(numbers[k] > lim for k, lim in ref.LIMITS.items())
    return {"workload": cell["name"], "seed": seed, "numbers": numbers,
            "limits": ref.LIMITS, "control_fails": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from gbbench import harness
    if not torch.cuda.is_available():
        print("gbbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_of(harness.load_benchmark(), args.workload)
    ok = True
    for seed in args.seeds:
        t = time.perf_counter()
        rec = readings(cell, seed, "cuda")
        rec["seconds"] = time.perf_counter() - t
        ok &= rec["control_fails"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
