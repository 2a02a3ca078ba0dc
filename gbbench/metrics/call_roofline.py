"""call_roofline: the least time a call could take on the card (its
compulsory bytes, ``roofline/<entry>.py``, over the published memory
rate, ``peaks.json``) over the device's busy time a call in the traced
window.  No operation term: counting and traversal have no operation
count independent of the algorithm.  Nothing where the card is not in
the table, the device was never busy, or the trace's kernel counts
disagree with the port's launch counter, and on a CPU run."""

from ..peaks import memory_rate


def read(ctx):
    tr = ctx["trace"]
    if (ctx["device"].type != "cuda" or tr is None
            or not tr["check"]["ok"] or tr["busy_s"] <= 0):
        return None
    import torch
    rate = memory_rate(torch.cuda.get_device_name(ctx["device"]))
    if rate is None:
        return None
    least = ctx["bytes_per_call"] / rate
    return 100.0 * least / (tr["busy_s"] / tr["calls"])
