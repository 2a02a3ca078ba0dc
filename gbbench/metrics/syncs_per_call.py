"""syncs_per_call: the port's device-to-host reads a call in the traced
window: its ``gb.read.*`` spans (``graphblas_tpu_torch.utils.counters``
records them while a profiler records) in the window's calls, over the
calls.  Nothing on a port without spans."""

from ..port_spans import read_spans_per_call


def read(ctx):
    if ctx["trace"] is None:
        return None
    return read_spans_per_call(ctx["calls"])
