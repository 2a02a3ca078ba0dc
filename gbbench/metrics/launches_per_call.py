"""launches_per_call: the change of the port's launch counter
(``_build.launches``, every hand-written kernel) over the window,
divided by the window's calls."""


def read(ctx):
    return sum(ctx["launches"].values()) / ctx["calls"]
