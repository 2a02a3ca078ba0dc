"""The single-card demos of the PyTorch port: counterparts of the
``demos/`` scripts of the JAX package, with the same result lines.

Run one as ``python -m graphblas_tpu_torch.demos.<name> [--device DEV]
[args]`` (``simple``, ``wildtype``, ``complex``, ``import``, ``mis``,
``bfs``, ``tri``, ``kron``, ``ktruss``, ``pagerank``).  The demos run on
the CUDA card unless ``--device`` names another device, such as
``cpu``; without a card and without ``--device`` they fail, as the
containers do.
"""
