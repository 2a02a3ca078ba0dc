"""transpose_span_ms: the host time a call spends transposing a
container: its ``gb.containers.transpose`` spans in the traced window's
calls, by the host clock, so the device sort's launches and any wait on
the card inside them.  Nothing on a port without spans."""

from ..port_spans import span_ms_per_call


def read(ctx):
    if ctx["trace"] is None:
        return None
    return span_ms_per_call(ctx["calls"], "gb.containers.transpose")
