"""Run one cell of BENCHMARK.json once on the card and print its result
line (the last line of standard output, one JSON object).

    python3 gbbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run under ``torch.profiler``.  The numbers the
correctness check compared are printed, each beside its limit, as the
last lines of standard error and under ``checks``, the line's last key.
Exits non-zero, printing no result, without enough CUDA devices, without
the port beside this folder, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from gbbench import harness

    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    try:
        import graphblas_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"gbbench: the port graphblas_tpu_torch is not beside "
              f"gbbench/: {exc}", file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gbbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = harness.run_cell(bench, cell, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gbbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
