"""Run one cell of BENCHMARK.json once: set-up, the measured window, the
check against the plain reference, and the metrics of the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is found by its name (``load_json``, ``load_module``); this file
holds only what every cell shares.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import re
import statistics
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "graphblas_tpu")


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``gbbench/<kind>/<name>.py`` as the module ``gbbench.<kind>.<name>``
    (a name's dots and dashes read as underscores)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no module gbbench/{kind}/{name}.py")
    modname = f"gbbench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if modname not in sys.modules:
        importlib.import_module(f"gbbench.{kind}")
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[modname]
            raise
    return sys.modules[modname]


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LookupError(f"BENCHMARK.json has no workload {name!r}")


def metrics_for(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those whose ``workloads`` list it, or that have no
    such list."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for the stream ``stream`` of a run's ``seed``: the
    graph's labels, the values and the sources each draw from their
    own."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The harness's spans around its calls into the port's layers, by
    the host clock, each ended by a device synchronize."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}

    @contextmanager
    def __call__(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


class Sampler:
    """The window's results that the check reads: every one when
    ``size`` is None, else a uniform sample of ``size`` of them drawn
    from the seed (reservoir sampling), each as (call index, result)."""

    def __init__(self, size, seed: int):
        self.size = size
        self.rng = np.random.default_rng(sub_seed(seed, 9))
        self.kept = []
        self.seen = 0

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if self.size is None or len(self.kept) < self.size:
            self.kept.append((i, out))
            return
        slot = int(self.rng.integers(0, self.seen))
        if slot < self.size:
            self.kept[slot] = (i, out)


def launch_counts() -> dict:
    from graphblas_tpu_torch import _build
    return dict(_build.launches)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, cfg: dict = None,
             traffic: dict = None) -> dict:
    """One run of ``cell``: returns the result line (a dict; the checks'
    numbers last, under ``checks``).  ``t0``: the process's start by
    ``time.perf_counter``; ``cfg`` and ``traffic`` stand in for the
    cell's files (the tests' small sizes)."""
    device = torch.device(device)
    cfg = cfg or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    entry = load_module("entries", traffic["entry"])
    ref = load_module("reference", traffic["entry"])
    graph = load_module("graphs", cfg["graph"]).make(cfg, seed, device)
    inputs = entry.make_inputs(graph, cfg, traffic, seed, device)
    del graph
    spans = Spans(device)
    state = entry.setup(inputs, cfg, traffic, spans, device)
    with spans("first_call"):
        entry.call(state, 0)
    setup_s = time.perf_counter() - t0

    sampler = Sampler(getattr(entry, "SAMPLE", None), seed)
    durations = []
    failed = 0
    launches0 = launch_counts()
    prof = None
    if trace:
        from . import peaks
        from . import trace as tr
        prof = tr.start(device)
    mark = (torch.profiler.record_function if prof is not None
            else lambda name: nullcontext())
    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while True:
        t = time.perf_counter()
        try:
            with mark("gbbench.call"):
                out = entry.call(state, i)
                sync(device)
        except Exception:
            failed += 1
            out = None
            if failed <= 3:
                traceback.print_exc(file=sys.stderr)
        t1 = time.perf_counter()
        durations.append(t1 - t)
        if out is not None:
            sampler.offer(i, out)
        del out
        i += 1
        if t1 >= deadline:
            break
    window_s = t1 - w0
    launches = {k: v - launches0.get(k, 0)
                for k, v in launch_counts().items()}
    summary = None
    if prof is not None:
        summary = tr.stop(prof, launches)
    # the cards a cell asks for are cuda:0 to cuda:<chips - 1>; the peak
    # is the fullest card's
    count = int(cell["chips"])
    peak = (max(torch.cuda.max_memory_allocated(k) for k in range(count))
            if device.type == "cuda" else 0)

    # the program's state goes before the reference runs on the card
    from graphblas_tpu_torch import last_axb_method
    engine = last_axb_method()
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    numbers, info = entry.check(inputs, sampler.kept, ref)
    check_s = time.perf_counter() - tc
    limits = ref.LIMITS
    correct = (failed == 0 and bool(sampler.kept)
               and all(numbers.get(k) is not None and numbers[k] <= lim
                       for k, lim in limits.items()))

    ctx = {"durations": durations, "calls": len(durations),
           "window_s": window_s, "setup_s": setup_s,
           "spans": spans.seconds, "launches": launches,
           "trace": summary, "info": info,
           "bytes_per_call": load_module(
               "roofline", traffic["entry"]).compulsory_bytes(info),
           "device": device}
    section = "per_layer" if trace else "end_to_end"
    metrics, left_out = {}, {}
    for m in metrics_for(bench, cell["name"], section):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif summary is not None and not summary["check"]["ok"]:
            left_out[m["name"]] = "profiler_check_failed"
        else:
            left_out[m["name"]] = "nothing to read"

    line = {"correct": correct, "attempted": len(durations),
            "failed": failed, "metrics": metrics,
            "device": device_record(device, peak, summary, count)}
    if summary is not None:
        line["breakdown"] = summary["breakdown"]
        line["profiler_check"] = summary["check"]
        line["card"] = peaks.card(device)
    if left_out:
        line["left_out"] = left_out
    q = statistics.quantiles(durations, n=4) if len(durations) > 1 else \
        [durations[0]] * 3
    line["run"] = {"engine": engine, "compared": len(sampler.kept),
                   "check_s": check_s, "seed": seed, "sizes": info,
                   "call_quartiles_ms": [1e3 * x for x in q]}
    line["checks"] = {k: {"value": numbers.get(k), "limit": lim}
                      for k, lim in limits.items()}
    return line


def device_record(device, peak: int, summary, count: int) -> dict:
    if device.type == "cuda":
        rec = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(device),
               "count": count, "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": count,
               "memory_peak_bytes": 0}
    if summary is not None:
        rec["busy_s"] = summary["busy_s"]
        rec["window_s"] = summary["window_s"]
    return rec
