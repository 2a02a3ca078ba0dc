"""io of the PyTorch port (counterparts of graphblas_tpu.io)."""
