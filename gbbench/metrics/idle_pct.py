"""idle_pct: the share of the traced window in which nothing ran on the
device (no kernel, copy or fill), from the profiler's trace; nothing
where the trace's kernel counts disagree with the port's launch
counter, and on a CPU run."""


def read(ctx):
    tr = ctx["trace"]
    if (ctx["device"].type != "cuda" or tr is None
            or not tr["check"]["ok"] or tr["window_s"] <= 0):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
