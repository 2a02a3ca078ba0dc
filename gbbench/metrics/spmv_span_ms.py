"""spmv_span_ms: the host time a call spends in the SpMV engines of
``csr_mxv`` (the ``vxm`` and ``mxv`` of a CSR operand): its
``gb.engines.spmv`` spans in the traced window's calls, by the host
clock.  Nothing on a port without spans."""

from ..port_spans import span_ms_per_call


def read(ctx):
    if ctx["trace"] is None:
        return None
    return span_ms_per_call(ctx["calls"], "gb.engines.spmv")
