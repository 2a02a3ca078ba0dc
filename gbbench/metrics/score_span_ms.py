"""score_span_ms: the host time a call spends drawing MIS's scores and
building its ``prob`` vector under the candidates mask (the stream's
jump-ahead on the card and the masked apply): its
``gb.engines.mis_score`` spans in the traced window's calls, by the
host clock.  Nothing on a port without spans."""

from ..port_spans import span_ms_per_call


def read(ctx):
    if ctx["trace"] is None:
        return None
    return span_ms_per_call(ctx["calls"], "gb.engines.mis_score")
