"""engine_span_ms: the host time a call spends in the port's engines:
its ``gb.engines.*`` spans (the slab passes, the ESC residual, the
combine, the epilogue) in the traced window's calls, by the host clock,
so the launches and the waits on the card inside them.  Nothing on a
port without spans."""

from ..port_spans import span_ms_per_call


def read(ctx):
    if ctx["trace"] is None:
        return None
    return span_ms_per_call(ctx["calls"], "gb.engines.")
