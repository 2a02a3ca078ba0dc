"""The port's counterparts of the repo's ``tools/``: the card probes
(the H100 counterparts of the JAX package's TPU probes), the scale run,
the slab-width sweep and the coverage harness, each run as ``python -m
graphblas_tpu_torch.tools.<name>``."""
