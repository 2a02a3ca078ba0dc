"""Dense tropical-semiring product C = A (min.+) B and its kin: a
hand-written CUDA kernel (K6).

Counterpart of ``graphblas_tpu/sparse/pallas_tropical.py``: the Pallas
TPU kernel becomes ``csrc/tropical.cu`` (``gb_tropical_mm``), built with
``nvcc`` on first use and called through ctypes on PyTorch's current
stream.  Tensor cores only sum products, so the tropical semirings
(MIN_PLUS, MAX_PLUS, MIN_MAX, MAX_MIN: the shortest-path and
bottleneck-path algebra) need a kernel of their own.

On a CUDA tensor :func:`tropical_mm` launches the kernel (float32 only;
another dtype raises) or raises; on a CPU tensor it runs the kernel's
plain PyTorch version, :func:`_tropical_mm_plain`, for any dtype.  Both
fold with the NaN-ignoring ``fmin``/``fmax`` from the add identity, so a
NaN term is ignored: where the JAX kernel's ``jnp.minimum`` gives NaN
(a NaN value, or ``+inf + -inf`` from an identity-filled absent entry),
these give what the JAX package's generic path gives.

The engine name is recorded by the caller (``ops/mxm.py``'s route):

    cuda:tropical_<add>_<mult> / torch:tropical_<add>_<mult>
        <->  pallas:tropical_<add>_<mult>
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

__all__ = ["tropical_mm", "TROPICAL_PAIRS"]

#: (add, mult) pairs this kernel serves, with their names
TROPICAL_PAIRS = {
    ("MIN", "PLUS"): "min_plus",
    ("MAX", "PLUS"): "max_plus",
    ("MIN", "MAX"): "min_max",
    ("MAX", "MIN"): "max_min",
    ("MIN", "TIMES"): "min_times",
    ("MAX", "TIMES"): "max_times",
}

#: the kernel's operation codes
_MULT_CODE = {"PLUS": 0, "TIMES": 1, "MIN": 2, "MAX": 3}

#: max elements of one [m, kc, n] block of the plain version
_PLAIN_BUDGET = 1 << 24


def _identity(add: str, dtype):
    """The add monoid's identity for a numpy dtype: +-inf for floats,
    the integer range's end otherwise."""
    if np.issubdtype(dtype, np.floating):
        return np.inf if add == "MIN" else -np.inf
    info = np.iinfo(dtype)
    return info.max if add == "MIN" else info.min


def _tropical_mm_plain(a: torch.Tensor, b: torch.Tensor, add: str,
                       mult: str) -> torch.Tensor:
    """Plain version of the kernel, any dtype: k blocks of the broadcast
    ``mult(a[:, k, None], b[None, k, :])`` ([m, kc, n] under a fixed
    budget), NaN terms replaced by the identity, reduced with min or max
    and folded into a carry that starts at the identity."""
    m, k = a.shape
    n = b.shape[1]
    ident = _identity(add, np.dtype(str(a.dtype).replace("torch.", "")))
    fold = torch.fmin if add == "MIN" else torch.fmax
    red = torch.amin if add == "MIN" else torch.amax
    multf = {"PLUS": torch.add, "TIMES": torch.mul, "MIN": torch.fmin,
             "MAX": torch.fmax}[mult]
    out = torch.full((m, n), ident, dtype=a.dtype, device=a.device)
    kc = max(1, min(k, _PLAIN_BUDGET // max(1, m * n)))
    for s in range(0, k, kc):
        z = multf(a[:, s:s + kc, None], b[None, s:s + kc, :])
        if z.is_floating_point():
            z = torch.where(torch.isnan(z), ident, z)
        out = fold(out, red(z, dim=1))
    return out


def tropical_mm(a: torch.Tensor, b: torch.Tensor, add: str = "MIN",
                mult: str = "PLUS") -> torch.Tensor:
    """C[i, j] = add_k mult(a[i, k], b[k, j]) over a tropical pair, for
    (m, k) and (k, n) tensors on one device."""
    if (add, mult) not in TROPICAL_PAIRS:
        raise ValueError(f"unsupported tropical pair {(add, mult)}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tropical_mm needs (m, k) and (k, n) operands, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError(f"operands differ: {a.dtype} on {a.device} and "
                         f"{b.dtype} on {b.device}")
    dev = a.device
    if dev.type == "cpu":
        return _tropical_mm_plain(a, b, add, mult)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if a.dtype != torch.float32:
        raise TypeError(f"the tropical kernel takes float32, got {a.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, k, n) >= 1 << 31:
        raise ValueError(f"dimensions ({m}, {k}, {n}) exceed int32")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    _build.launch("tropical_mm", a, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  m, k, n, int(add == "MAX"), _MULT_CODE[mult])
    return c
