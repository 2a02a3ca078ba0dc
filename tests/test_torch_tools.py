"""PyTorch port, the repo tools (``graphblas_tpu_torch/tools/``
``scale_run``, ``valdot_sweep``, ``coverage``): parity with the JAX
package's ``tools/scale_run.py`` and ``tools/valdot_sweep.py``, which
are imported by path and run on the CPU.

The JSON lines must agree: the graph's nnz, the triangle count, the BFS
levels and visited count, and the plan fields of each slab width
exactly; the PageRank rank sum within 1e-5 relative and the valued
product's value sum within 1e-5 relative (float32 sums in another
order).  The coverage tool runs in a subprocess on one small test file.
Without a card, a tool not given ``--device cpu`` raises."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphblas_tpu.sparse import bitdot as jbd
from graphblas_tpu.core.semirings import semiring as jsemiring
import graphblas_tpu as gb
from graphblas_tpu.sparse import valdot as jvd
from graphblas_tpu_torch.sparse import bitdot as tbd
from graphblas_tpu_torch.tools import coverage as tcov
from graphblas_tpu_torch.tools import scale_run as tsr
from graphblas_tpu_torch.tools import valdot_sweep as tvs

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(out: str) -> list:
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


@pytest.fixture(scope="module")
def jsr():
    return _jax_tool("scale_run")


@pytest.fixture(scope="module")
def jvs():
    return _jax_tool("valdot_sweep")


@pytest.mark.parametrize("scale", [10, 12])
def test_scale_run_matches_jax(jsr, capsys, scale):
    A, n, nnz = jsr.build(scale)
    jsr.run_tricount(A, n, nnz, scale)
    jsr.run_bfs(A, n, nnz, scale)
    jsr.run_pagerank(A, n, nnz, scale)
    want = {r["alg"]: r for r in _lines(capsys.readouterr().out)}
    recs = tsr.main([str(scale), "--device", "cpu"])
    got = {r["alg"]: r for r in recs}
    assert _lines(capsys.readouterr().out) == recs
    assert [r["alg"] for r in recs] == ["build", "tricount", "bfs",
                                        "pagerank"]
    for r in recs:
        assert r["device"] == "cpu" and r["scale"] == scale
        assert r["n"] == n and r["nnz"] == nnz
        if "peak_dev_bytes" in r:
            assert r["peak_dev_bytes"] is None
    # the JAX tool's keys, plus "device"
    for alg, r in want.items():
        assert set(got[alg]) == set(r) | {"device"}, alg
    assert got["tricount"]["ntri"] == want["tricount"]["ntri"]
    for k in ("levels", "visited"):
        assert got["bfs"][k] == want["bfs"][k], k
    np.testing.assert_allclose(got["pagerank"]["rank_sum"],
                               want["pagerank"]["rank_sum"], rtol=1e-5)


def test_scale_run_algs_and_results():
    """``--algs`` picks the algorithms; the functions hand back their
    results: the prep's factors, BFS's visited vector (== the levels of
    ``bfs_csr``), the rank vector (== its float64 recurrence)."""
    from graphblas_tpu_torch.sparse.algorithms import bfs_csr
    recs = tsr.main(["10", "--algs", "bfs", "--device", "cpu"])
    assert [r["alg"] for r in recs] == ["build", "bfs"]
    A, n, nnz = tsr.build(10, "cpu")
    rec, (L, U) = tsr.run_tricount(A, n, nnz, 10)
    assert L.nvals + U.nvals == nnz and rec["ntri"] > 0
    rec, visited = tsr.run_bfs(A, n, nnz, 10)
    lev = bfs_csr(A, 0)
    assert rec["levels"] == lev.max() - 1
    assert np.array_equal(visited.numpy(), lev > 0)
    rec, r = tsr.run_pagerank(A, n, nnz, 10)
    I, J, _ = A.extractTuples()
    deg = np.maximum(np.bincount(I, minlength=n), 1).astype(np.float64)
    r64 = np.full(n, 1.0 / n)
    for _ in range(20):
        y = np.zeros(n)
        np.add.at(y, I, (0.85 * r64 / deg)[J])
        r64 = y + 0.15 / n
    np.testing.assert_allclose(r.numpy(), r64, rtol=1e-5)
    with pytest.raises(SystemExit):
        tsr.main(["10", "--algs", "sssp", "--device", "cpu"])


def test_valdot_sweep_matches_jax(jvs, capsys, monkeypatch):
    """R-MAT 12 with S in {1024, 2048}: its 1.6 M wedges are under the
    plans' 2^22 floor, lowered to 1 in both packages (as
    ``test_torch_valdot.py`` does)."""
    monkeypatch.setattr(jbd, "_MIN_LANES", 1)
    monkeypatch.setattr(tbd, "_MIN_LANES", 1)
    built = []
    jbuild = jvs.build
    monkeypatch.setattr(jvs, "build",
                        lambda s: built.append(jbuild(s)) or built[-1])
    monkeypatch.setattr(sys, "argv", ["valdot_sweep.py", "12", "1024",
                                      "2048"])
    jvs.main()
    want = _lines(capsys.readouterr().out)
    Lj, Uj, Mj = built[0]
    Cj = jvd.valdot_masked_spgemm(jsemiring.plus_times[gb.FP32], Lj, Uj, Mj)
    want_sum = float(np.asarray(Cj.values[:Cj.nvals], np.float64).sum())
    recs, C = tvs.sweep(*tvs.build(12, "cpu"), [1024, 2048], 12)
    assert _lines(capsys.readouterr().out) == recs
    assert [r["S"] for r in recs] == [r["S"] for r in want] == [1024, 2048]
    for g, w in zip(recs, want):
        assert set(g) == set(w) | {"device"}
        for k in ("scale", "levels", "sum_nlive", "kcut", "light_lanes",
                  "nnzC"):
            assert g[k] == w[k], (g["S"], k)
        np.testing.assert_allclose(g["cov_pct"], w["cov_pct"], rtol=1e-12)
    got_sum = float(C.values[:C.nvals].double().sum())
    np.testing.assert_allclose(got_sum, want_sum, rtol=1e-5)


def test_coverage_reports_the_port_only():
    out = subprocess.run(
        [sys.executable, "-m", "graphblas_tpu_torch.tools.coverage",
         "--device", "cpu", "tests/test_torch_counters.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    table = out.stdout.split("=== graphblas_tpu_torch statement coverage ===")
    rows = [s.split() for s in table[1].strip().splitlines()]
    assert rows[-1][0] == "TOTAL" and len(rows) > 50
    pct = {r[0]: float(r[2].rstrip("%")) for r in rows}
    assert all(k.startswith("graphblas_tpu_torch/") for k in pct
               if k != "TOTAL")
    assert pct["graphblas_tpu_torch/utils/counters.py"] > 50
    assert pct["graphblas_tpu_torch/__init__.py"] > 50
    assert 0 < pct["TOTAL"] < 100


def test_coverage_helpers():
    assert tcov._split_device(["--device", "cpu", "-q", "x.py"]) == \
        ("cpu", ["-q", "x.py"])
    assert tcov._split_device(["--device=cuda", "-k", "a"]) == \
        ("cuda", ["-k", "a"])
    assert tcov._split_device(["-q"]) == (None, ["-q"])
    lines = tcov.executable_lines(tcov.__file__)
    assert lines and min(lines) >= 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("run", [
    lambda: tsr.main(["10"]),
    lambda: tvs.main(["10", "1024"]),
    lambda: tcov.main(["tests/test_torch_counters.py"]),
], ids=["scale_run", "valdot_sweep", "coverage"])
def test_tools_raise_without_a_card(run):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
