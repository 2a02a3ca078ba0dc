"""Probes of the card: the H100 counterparts of the JAX package's TPU
probes in ``tools/``, each run as ``python -m
graphblas_tpu_torch.tools.<name>``."""
