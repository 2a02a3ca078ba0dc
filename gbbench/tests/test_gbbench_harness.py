"""The harness: BENCHMARK.json's shape and its lookup of cells,
configurations, entries and metrics by name; the module guard; the
result line of a run at a small size on the CPU; and each fault the
cells can have, planted under the timed path, turning ``correct``
false."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

import graphblas_tpu_torch as gt
from gbbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cfg(cell: str, sizes: str = "test_sizes") -> dict:
    """The cell's configuration at the size its file gives for
    ``sizes`` (falling back to ``test_sizes``)."""
    cfg = harness.load_json("configs", harness.cell_of(BENCH,
                                                       cell)["config"])
    return dict(cfg, **cfg.get(sizes, cfg["test_sizes"]))


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gbbench/run.py"]
    assert BENCH["paths"] == ["gbbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gbbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for cell in CELLS:
        ends = {m["name"] for m in harness.metrics_for(BENCH, cell,
                                                       "end_to_end")}
        assert "setup_s" in ends and len(ends) >= 2
        layers = harness.metrics_for(BENCH, cell, "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in ends and m["moves"] in e2e


def test_lookup_by_name():
    """Every cell finds its configuration, traffic, generator, entry,
    reference and roofline, and every metric its reader, by name."""
    used = set()
    for w in BENCH["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        assert json.loads((harness.REPO / conf["file"]).read_text()) == cfg
        assert conf["reduced"] == cfg["reduced"]
        assert all(k in cfg for k in cfg["reduced"])
        # the benchmark's own tests run each configuration at these
        assert set(cfg["test_sizes"]) <= set(cfg) - {"test_sizes"}
        used.add(w["config"])
        traffic = harness.load_json("traffic", w["traffic"])
        harness.load_module("graphs", cfg["graph"]).make
        for kind in ("entries", "reference", "roofline"):
            assert harness.load_module(kind, traffic["entry"])
        ref = harness.load_module("reference", traffic["entry"])
        assert ref.LIMITS and hasattr(ref, "control_numbers")
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    with pytest.raises(LookupError):
        harness.load_module("entries", "no_such_entry")
    with pytest.raises(LookupError):
        harness.load_json("traffic", "no-such-mix")
    with pytest.raises(LookupError):
        harness.cell_of(BENCH, "no-such-cell")


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["graphblas_tpu_torch", "graphblas_tpu_torch.sparse.tri",
         "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax",
         "graphblas_tpu", "graphblas_tpu.sparse", "torch"]) == [
        "flax", "graphblas_tpu", "graphblas_tpu.sparse", "jax",
        "jax.numpy", "jaxlib.xla_client"]


def test_nothing_forbidden_is_loaded_by_a_run():
    """A run's modules: the port, the harness and the references load
    neither JAX nor the JAX package (in a fresh process: this test
    process may hold them from elsewhere)."""
    code = ("import sys; sys.path.insert(0, %r); import time; "
            "from gbbench import harness; b = harness.load_benchmark(); "
            "[harness.run_cell(b, harness.cell_of(b, c), 1, 0.05, False, "
            "'cpu', time.perf_counter(), cfg=cfg) for c, cfg in %r]; "
            "print(harness.forbidden_modules())"
            % (str(harness.REPO), [(c, small_cfg(c)) for c in CELLS]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def run_small(cell: str, trace: bool = False, seconds: float = 0.2,
              seed: int = 2**31 + 99):
    return harness.run_cell(BENCH, harness.cell_of(BENCH, cell), seed,
                            seconds, trace, "cpu", time.perf_counter(),
                            cfg=small_cfg(cell))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    line = run_small(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    section = "per_layer" if trace else "end_to_end"
    # the CPU gives no device metric, and the line says so
    wanted = harness.metrics_for(BENCH, cell, section)
    want = {m["name"]: m["unit"] for m in wanted
            if m["source"] != "device_trace"}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert line.get("left_out", {}) == {
        m["name"]: "nothing to read" for m in wanted
        if m["source"] == "device_trace"}
    assert line["device"]["count"] == harness.cell_of(BENCH, cell)["chips"]
    assert all(isinstance(v["value"], float) and v["value"] >= 0
               for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    json.dumps(line)


def test_same_seed_same_inputs():
    from gbbench.entries import mxm
    from gbbench.graphs import kron
    cfg = dict(harness.load_json("configs", "gap-kron-20"), scale=8)
    traffic = harness.load_json("traffic", "mxm")
    a, b = (mxm.make_inputs(kron.make(cfg, 2**31 + 5, "cpu"), cfg, traffic,
                            2**31 + 5, "cpu") for _ in range(2))
    for k in "LUM":
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
    c = mxm.make_inputs(kron.make(cfg, 6, "cpu"), cfg, traffic, 6, "cpu")
    assert not torch.equal(a["L"][2], c["L"][2])


# -- faults planted under the timed path ---------------------------------

def _half(A):
    """A with every other stored entry left out."""
    keep = torch.arange(A.nzmax) % 2 == 0
    return gt.csr_filter_lanes(A, keep)


def _unchanged_levels(A, s):
    lev = torch.zeros(A.nrows, dtype=torch.int32)
    lev[s] = 1
    return lev.numpy()


#: the faults a cell can have, by the entry its traffic names: each
#: takes the port's function and returns it broken
FAULTS = {
    "tricount_auto": {
        "answer altered": lambda real: lambda L, U: real(L, U) + 1,
        "state unchanged": lambda real: lambda L, U: 0,
        "half the batch, doubled": lambda real: lambda L, U:
            2 * real(_half(L), U),
    },
    "mxm": {
        "answer altered": lambda real: lambda C, M, a, s, L, U:
            _bump(real(C, M, a, s, L, U)),
        "state unchanged": lambda real: lambda C, M, a, s, L, U: C,
        "half the batch": lambda real: lambda C, M, a, s, L, U:
            real(C, _half(M), a, s, L, U),
    },
    "bfs_csr": {
        "answer altered": lambda real: lambda A, s: _bump_level(real(A, s)),
        "state unchanged": lambda real: _unchanged_levels,
        "half the batch": lambda real: lambda A, s: real(_half(A), s),
    },
}


def entry_of(cell: str) -> str:
    return harness.load_json("traffic",
                             harness.cell_of(BENCH, cell)["traffic"])["entry"]


def _bump(C):
    C = C.wait()
    C.values[C.nvals // 2] += 1.0
    return C


def _bump_level(lev):
    lev = lev.copy()
    lev[int(lev.argmax())] += 1
    return lev


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS.get(entry_of(c), ())])
def test_fault_turns_correct_false(monkeypatch, cell, fault):
    """The entry's function of the port (the entry and the function
    share the name) broken under the timed path."""
    fn = entry_of(cell)
    real = getattr(gt, fn)
    monkeypatch.setattr(gt, fn, FAULTS[fn][fault](real))
    line = run_small(cell)
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values())


def test_a_raising_call_is_failed(monkeypatch):
    def boom(L, U):
        raise RuntimeError("planted")
    line_ok = run_small("kron20-tc")
    assert line_ok["correct"]
    real = gt.tricount_auto
    calls = {"n": 0}

    def sometimes(L, U):
        calls["n"] += 1
        return boom(L, U) if calls["n"] == 3 else real(L, U)
    monkeypatch.setattr(gt, "tricount_auto", sometimes)
    line = run_small("kron20-tc")
    assert line["failed"] == 1 and line["correct"] is False


# -- the command ----------------------------------------------------------

def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "gbbench/run.py", "--workload",
                          "kron20-tc", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=harness.REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("chips", [1, 4])
def test_run_refuses_fewer_cards_than_the_cell_asks(monkeypatch, capsys,
                                                    chips):
    """A cell on ``chips`` cards gives no result where one card fewer
    is found."""
    from gbbench import run
    bench = json.loads(json.dumps(BENCH))
    harness.cell_of(bench, CELLS[0])["chips"] = chips
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: chips > 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: chips - 1)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and f"needs {chips} CUDA device" in out.err


def test_run_refuses_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and gbbench/ gives no
    result."""
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "gbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gbbench/run.py", "--workload",
                          "kron20-tc", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "graphblas_tpu_torch" in out.stderr


def test_control_comes_out_not_correct():
    """The control script's readings at a small size: each cell's
    control fails one of its numbers."""
    from gbbench import control
    for cell in CELLS:
        rec = control.readings(harness.cell_of(BENCH, cell), 2**31 + 3,
                               "cpu", small_cfg(cell, "control_test_sizes"))
        assert rec["control_fails"], rec


def test_bfs_sources_same_structure_every_seed():
    """Every seed searches from the same vertices of the structure (so
    does the same work), under its own labels and in its own order."""
    from gbbench.entries import bfs_csr
    from gbbench.graphs import kron
    cfg = dict(harness.load_json("configs", "gap-kron-20"), scale=10)
    traffic = harness.load_json("traffic", "bfs")
    picks = []
    for seed in (2**31 + 1, 2**31 + 2):
        g = kron.make(cfg, seed, "cpu")
        src = bfs_csr.make_inputs(g, cfg, traffic, seed, "cpu")["sources"]
        assert len(src) == traffic["sources"] == len(set(src))
        deg = torch.bincount(g["I"], minlength=g["n"])
        assert all(deg[s] > 0 for s in src)
        where = {int(v): i for i, v in enumerate(g["labels"].tolist())}
        picks.append([where[s] for s in src])
    assert sorted(picks[0]) == sorted(picks[1]) and picks[0] != picks[1]
