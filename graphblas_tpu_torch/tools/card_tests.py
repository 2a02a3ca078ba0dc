"""Run the port's card-only tests (``@pytest.mark.cuda``) on a machine
that has a CUDA card but not the reference package's dependencies.

The parity test files import the JAX package at their top, and their
conftest configures JAX; the card-only tests in them call only this
port.  This runner answers every import of the reference package and of
``jax`` with a stand-in module (any attribute of which is another
stand-in) before pytest imports the test files, then runs ``pytest -m
cuda`` on the test files that hold card-only tests.  Nothing of the
reference package is imported.

    python -m graphblas_tpu_torch.tools.card_tests [pytest arguments]

Exits with pytest's code, and nonzero without a CUDA card.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
from pathlib import Path
from unittest import mock

import torch

#: top-level packages the card-only tests never call
STAND_INS = ("jax", "graphblas_tpu")

#: the test files that hold card-only tests
FILES = ("test_torch_bitdot.py", "test_torch_bsr.py",
         "test_torch_bsr_spmv.py", "test_torch_complex.py",
         "test_torch_probes.py", "test_torch_simple_rand_device.py",
         "test_torch_tropical.py", "test_torch_udt_ops.py",
         "test_torch_valdot.py", "test_torch_valdot_compact.py",
         "test_torch_window.py")

TESTS = Path(__file__).resolve().parents[2] / "tests"


class _StandIns(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if any(name == p or name.startswith(p + ".") for p in STAND_INS):
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        return mock.MagicMock(name=spec.name)

    def exec_module(self, module):
        pass


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        sys.exit("card_tests: no CUDA device; these tests need one")
    import pytest
    sys.meta_path.insert(0, _StandIns())
    args = list(sys.argv[1:] if argv is None else argv)
    return pytest.main(["-m", "cuda", "-p", "no:cacheprovider",
                        *(str(TESTS / f) for f in FILES), *args])


if __name__ == "__main__":
    sys.exit(main())
