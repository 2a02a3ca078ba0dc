"""ewise_span_ms: the host time a call spends in the bitmap
``eWiseAdd``, ``eWiseMult`` and ``apply`` of ``ops/ewise.py``: its
``gb.engines.ewise`` spans in the traced window's calls, by the host
clock.  Nothing on a port without spans."""

from ..port_spans import span_ms_per_call


def read(ctx):
    if ctx["trace"] is None:
        return None
    return span_ms_per_call(ctx["calls"], "gb.engines.ewise")
