"""setup_s: process start to the first timed call (imports, CUDA
initialisation, the kernel library's load or build, making the graph,
handing it to the port, its preparation and the warm-up call)."""


def read(ctx):
    return ctx["setup_s"]
