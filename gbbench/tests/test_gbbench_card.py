"""Every cell at a small size on the card, traced: correct, the
profiler's kernel counts within the trace reader's tolerance of the
port's launch counter, and every per-layer metric read.  Each run is a
process of its own, as a run of the benchmark is: with several profiler
sessions in one process the profiler missed up to 15 of 7,067 K1
launches, over that tolerance.  Skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from gbbench import harness

BENCH = harness.load_benchmark()

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from gbbench import harness
b = harness.load_benchmark()
w = harness.cell_of(b, {cell!r})
cfg = harness.load_json("configs", w["config"])
cfg = dict(cfg, **cfg.get("card_test_sizes", cfg["test_sizes"]))
print(json.dumps(harness.run_cell(b, w, 2**31 + 17, 1.0, True, "cuda:0",
                                  time.perf_counter(), cfg=cfg)))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card_traced(card, cell):
    chips = harness.cell_of(BENCH, cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    code = RUN.format(root=str(harness.REPO), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    check = line["profiler_check"]
    assert check["ok"], check
    want = {m["name"] for m in harness.metrics_for(BENCH, cell,
                                                   "per_layer")}
    assert set(line["metrics"]) == want and "left_out" not in line
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == harness.cell_of(BENCH, cell)["chips"]
    for k, v in line["metrics"].items():
        if k.split(".")[0].endswith("_roofline"):
            assert 0 < v["value"] < 100
