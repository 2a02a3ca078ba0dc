"""Statement coverage of the port: the counterpart of ``tools/coverage.py``
(the reference's ``Tcov``).

Instruments at runtime with ``sys.monitoring`` (PEP 669; a ``settrace``
fallback before Python 3.12), restricted to ``graphblas_tpu_torch/``,
runs pytest in this process, and prints the executed / executable lines
of each module and the total.  A line is recorded the first time it
runs and its event is then switched off, so the tests run at nearly
their own speed.  Code that runs only in child processes (the rank
processes of ``parallel/``, the demos run as programs) is not counted.

    python -m graphblas_tpu_torch.tools.coverage --device cpu [pytest args...]

With ``--device cpu`` the default arguments are every
``tests/test_torch_*.py`` (the parity tests need the JAX package).  On
the card (the default; without one it raises) the tool runs the
card-only tests of :mod:`.card_tests` with the same stand-ins for the
reference package, which cover the kernel launches the CPU cannot reach.
"""

from __future__ import annotations

import dis
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = str(ROOT / "graphblas_tpu_torch")
_PREFIX = PKG + os.sep
NAME = "graphblas_tpu_torch"

executed: dict = {}  # filename -> set of line numbers


def start() -> None:
    """Record every line of the package that runs from now on."""
    mon = getattr(sys, "monitoring", None)
    if mon is None:  # pragma: no cover - before Python 3.12
        def tracer(frame, event, arg):
            if event == "line":
                fn = frame.f_code.co_filename
                if fn.startswith(_PREFIX):
                    executed.setdefault(fn, set()).add(frame.f_lineno)
            return tracer
        sys.settrace(tracer)
        return

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(_PREFIX):
            executed.setdefault(fn, set()).add(line)
        return mon.DISABLE      # this line is recorded (or not ours)

    mon.use_tool_id(mon.COVERAGE_ID, "gbtpu-torch-cov")
    mon.register_callback(mon.COVERAGE_ID, mon.events.LINE, on_line)
    mon.set_events(mon.COVERAGE_ID, mon.events.LINE)


def stop() -> None:
    mon = getattr(sys, "monitoring", None)
    if mon is None:  # pragma: no cover - before Python 3.12
        sys.settrace(None)
        return
    mon.set_events(mon.COVERAGE_ID, 0)
    mon.free_tool_id(mon.COVERAGE_ID)


def executable_lines(path: str) -> set:
    """Lines bearing executable statements (from the compiled code's
    instruction positions)."""
    with open(path) as f:
        src = f.read()
    try:
        code = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for inst in dis.get_instructions(co):
            if inst.positions and inst.positions.lineno:
                lines.add(inst.positions.lineno)
        for const in co.co_consts:
            if hasattr(const, "co_code"):
                stack.append(const)
    return lines


def report() -> None:
    """Print the per-module table and the total."""
    print(f"\n=== {NAME} statement coverage ===")
    total_exec = total_all = 0
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d not in ("build", "__pycache__"))
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            alll = executable_lines(path)
            if not alll:
                continue
            ran = executed.get(path, set()) & alll
            name = os.path.relpath(path, ROOT)
            print(f"{name:55s} {len(ran):5d}/{len(alll):<5d} "
                  f"{100 * len(ran) / len(alll):5.1f}%")
            total_exec += len(ran)
            total_all += len(alll)
    print(f"{'TOTAL':55s} {total_exec:5d}/{total_all:<5d} "
          f"{100 * total_exec / max(total_all, 1):5.1f}%")


def _split_device(argv: list) -> tuple:
    """(device or None, the remaining arguments)."""
    rest, device = [], None
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def main(argv=None) -> int:
    import torch
    device, args = _split_device(list(sys.argv[1:] if argv is None
                                      else argv))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("coverage: no CUDA device; pass --device cpu "
                               "to cover the CPU tests")
        device = "cuda"
    if device not in ("cpu", "cuda"):
        raise ValueError(f"coverage: unknown device {device!r}")
    if device == "cuda":
        from . import card_tests
        sys.meta_path.insert(0, card_tests._StandIns())
        args = ["-m", "cuda", *(str(card_tests.TESTS / f)
                                for f in card_tests.FILES), *args]
    elif not any(os.path.exists(a.split("::")[0]) for a in args):
        args = [*sorted(str(p) for p in (ROOT / "tests").glob(
            "test_torch_*.py")), *args]
    import pytest
    # the package was imported before the monitor started (as this
    # module's parent): drop it, so the tests import it anew and its
    # module-level lines count
    for name in [m for m in sys.modules
                 if m == NAME or m.startswith(NAME + ".")]:
        del sys.modules[name]
    start()
    try:
        rc = pytest.main(["-q", "-p", "no:cacheprovider", *args])
    finally:
        stop()
    report()
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
