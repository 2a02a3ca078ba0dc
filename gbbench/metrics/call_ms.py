"""call_ms: the measured window over the calls completed in it
(closed loop, each call ended by a device synchronize), by the host
clock."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["calls"]
