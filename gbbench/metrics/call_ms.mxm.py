"""call_ms.mxm: call_ms in the cells of the masked product, whose call
is host-bound and spreads wider run to run (PERF.md section 2), so
that its bound does not loosen the other cells'."""

from .call_ms import read  # noqa: F401
