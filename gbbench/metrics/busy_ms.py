"""busy_ms: the device's busy time a call in the traced window (the
union of every kernel, copy and fill, over the calls traced): a steadier
reading of the device's share of call_ms than the host clock gives."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["device"].type != "cuda" or tr is None or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["calls"]
