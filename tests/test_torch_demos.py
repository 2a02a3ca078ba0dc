"""PyTorch port: the ten single-card demos (``graphblas_tpu_torch.demos``)
run end to end in subprocesses with ``--device cpu``, beside their JAX
counterparts in ``demos/`` (``JAX_PLATFORMS=cpu``).  Each pair must
print the same result lines (the timing fields of ``tri`` and ``kron``
taken out), and ``kron`` must write the same triplet file, byte for
byte.  The graph-reading demos also run on a seeded random graph file.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ENV = dict(os.environ, JAX_PLATFORMS="cpu")

# the timing fields: "...: 0.001234 s rate 1.00 M edges/s" (tri) and
# ", 0.056 s (0.00 M entries/s, 2 shards)" (kron)
_TIMES = (re.compile(r": [0-9.]+ s( rate .*)?$"),
          re.compile(r", [0-9.]+ s \(.*\)$"))


def _result_lines(out: str):
    lines = []
    for ln in out.splitlines():
        for pat in _TIMES:
            ln = pat.sub("", ln)
        lines.append(ln)
    return lines


def _run(cmd, env=None, timeout=240):
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=timeout)
    assert r.returncode == 0, f"{cmd} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def run_both(name, *args):
    """(port stdout, JAX stdout) of one demo with the same arguments."""
    port = _run([sys.executable, "-m", f"graphblas_tpu_torch.demos.{name}",
                 "--device", "cpu", *args])
    jax = _run([sys.executable, str(ROOT / "demos" / f"{name}_demo.py"),
                *args], env=JAX_ENV)
    return port, jax


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    """A seeded random directed graph of 60 nodes as a triplet file."""
    rng = np.random.default_rng(5)
    I, J = rng.integers(0, 60, 400), rng.integers(0, 60, 400)
    path = tmp_path_factory.mktemp("graph") / "g.tsv"
    path.write_text("".join(f"{i} {j} 1\n" for i, j in zip(I, J)))
    return str(path)


@pytest.mark.parametrize("demo,expect", [
    ("simple", "simple_demo OK"),
    ("wildtype", "wildtype_demo OK"),
    ("complex", "complex_demo OK"),
    ("import", "import_demo OK"),
    ("mis", "maximal independent set status verified"),
    ("bfs", "nodes reachable from node 0"),
    ("ktruss", "steps (graphblas path)"),
])
def test_demo_matches_jax(demo, expect):
    port, jax = run_both(demo)
    assert expect in port
    assert _result_lines(port) == _result_lines(jax)


def test_tri_demo_matches_jax():
    port, jax = run_both("tri")
    counts = {ln.split()[1] for ln in port.splitlines()
              if ln.startswith("triangles:")}
    assert len(counts) == 1, f"methods disagree: {port}"
    assert _result_lines(port) == _result_lines(jax)


@pytest.mark.parametrize("demo", ["mis", "bfs", "tri", "ktruss",
                                  "pagerank"])
def test_graph_file_demo_matches_jax(demo, graph_file):
    port, jax = run_both(demo, graph_file)
    assert _result_lines(port) == _result_lines(jax)


def test_kron_demo_matches_jax(tmp_path):
    a = tmp_path / "a.tsv"
    b = tmp_path / "b.tsv"
    a.write_text("0 1 2\n1 0 3\n2 2 0.5\n")
    b.write_text("0 0 1\n1 1 5\n0 2 -1.25\n")
    port = _run([sys.executable, "-m", "graphblas_tpu_torch.demos.kron",
                 "--device", "cpu", str(a), str(b), str(tmp_path / "ct.tsv"),
                 "2"])
    jax = _run([sys.executable, str(ROOT / "demos" / "kron_demo.py"),
                str(a), str(b), str(tmp_path / "cj.tsv"), "2"], env=JAX_ENV)
    assert "C = kron(A,B): 6 x 9, 9 entries" in port
    assert _result_lines(port) == _result_lines(jax)
    body = (tmp_path / "ct.tsv").read_bytes()
    assert body == (tmp_path / "cj.tsv").read_bytes()
    assert b"0\t3\t2\n" in body and b"4\t8\t-0.625\n" in body


def test_demo_without_a_card_fails():
    """Without ``--device`` a demo runs on the card, and without one it
    fails rather than carry on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    r = subprocess.run([sys.executable, "-m",
                        "graphblas_tpu_torch.demos.simple"],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=240)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _dist_lines(out: str):
    """The distributed demos' result lines: the device line, the mesh
    shape (8 JAX devices, 4 ranks), the timings and the top PageRank
    node (a tie between symmetric nodes, broken by rounding) taken
    out."""
    subs = ((r", mesh \(.*\)$", ""), (r"top node \d+ ", ""),
            (r" \([0-9.]+s gen\)", ""), (r"^csr build: [0-9.]+s", "csr build:"),
            (r"^spmv: .*$", "spmv:"), (r"^bfs: [0-9.]+s, ", "bfs: "))
    lines = []
    for ln in out.splitlines():
        if ln.startswith(("devices:", "ranks:")):
            continue
        for pat, rep in subs:
            ln = re.sub(pat, rep, ln)
        lines.append(ln)
    return lines


@pytest.mark.parametrize("demo,args,expect", [
    ("dist", (), "dist_demo OK"),
    ("large", ("10", "8"), "large_demo OK"),
])
def test_dist_demos_match_jax(demo, args, expect):
    """The distributed demos on 4 gloo ranks beside the JAX demos on 8
    virtual devices."""
    port, jax = run_both(demo, *args)
    if demo == "dist":
        assert port.splitlines()[0] == "ranks: 4 x gloo on cpu"
    assert expect in port
    assert _dist_lines(port) == _dist_lines(jax)


def test_dist_demo_world_and_backend():
    """``--world`` sets the rank count; NCCL refuses CPU ranks."""
    out = _run([sys.executable, "-m", "graphblas_tpu_torch.demos.dist",
                "--device", "cpu", "--world", "2"])
    assert out.splitlines()[0] == "ranks: 2 x gloo on cpu"
    assert "dist_demo OK" in out
    r = subprocess.run([sys.executable, "-m",
                        "graphblas_tpu_torch.demos.dist", "--device", "cpu",
                        "--backend", "nccl"], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=240)
    assert r.returncode != 0
    assert "nccl backend carries CUDA tensors only" in r.stderr
