"""core of the PyTorch port (counterparts of graphblas_tpu.core)."""
