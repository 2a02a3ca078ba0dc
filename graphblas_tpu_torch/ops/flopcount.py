"""AxB engine attribution (the reference's ``AxB_method_used``).

Counterpart of ``graphblas_tpu/ops/flopcount.py``; the flop-count cost
model comes with the general masked SpGEMM slice.

Engine names match the JAX package's, except where a kernel replaces a
Pallas kernel: the JAX name ``pallas:<engine>`` becomes ``cuda:<engine>``
when the hand-written CUDA kernel ran and ``torch:<engine>`` when its
plain PyTorch version ran (a CPU tensor).  :func:`jax_engine_name` maps a
port name back to the JAX package's name.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["last_axb_method", "record_axb_method", "jax_engine_name"]

_LAST_METHOD = {"method": None}


def record_axb_method(method: str) -> None:
    _LAST_METHOD["method"] = method
    from ..utils import counters
    counters.record_method(method)


def last_axb_method() -> Optional[str]:
    """Engine used by the most recent product (AxB_method_used)."""
    return _LAST_METHOD["method"]


def jax_engine_name(method: str) -> str:
    """The JAX package's name for the engine the port recorded as
    ``method``: ``cuda:tri_band_ring`` and ``torch:tri_band_ring`` both
    map to ``pallas:tri_band_ring``; other names are shared."""
    route, sep, engine = method.partition(":")
    if sep and route in ("cuda", "torch"):
        return f"pallas:{engine}"
    return method
