"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

The sources in ``csrc/`` are compiled on first use, one ``nvcc`` per
source, all started together, and linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds),
named by a hash of the sources and flags and written to ``build/``
beside this file; a changed source gets a new library.  Each
launcher is ``extern "C"``, takes device pointers, sizes and the CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``.

Importing this module builds nothing: :func:`library` does, when a
wrapper first launches a kernel on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["library", "launch", "launches", "reset_launches",
           "build_info"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: launcher name -> argument types (every pointer and the stream last)
_SIGNATURES = {
    # P, Ut, rows, cols, kptr, kblk, partials, nout, Wb, stream
    "tri_band_ring": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # P, Q, M, rows, cols, kptr, kblk, partials, nout, W, nJ, stream
    "window_count": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # Apack, bptr, bwidx, bword, amap, bmap, rowids, indices, out,
    # nzmax, nvals, na, nb, W, amap_len, bmap_len, stream
    "bitdot_popcount": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _L, _L, _I, _I, _I, _I, _I, _P),
    # Av, Bv, ai, bj, out, nlive, na, nb, S, is_int, stream
    "valdot_gatherdot": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # aptr, aslot, aval, bptr, bslot, bval, ai, bj, out, E, nlive, na, nb,
    # S, is_int, stream
    "valdot_gatherdot_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L,
                              _I, _I, _I, _I, _P),
    # rbptr, cb, slot, valid, tiles, x, y, nrb, stream
    "bsr_spmv": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    # P, Q, M, out, nI, W, nJ, stream
    "window_mm": (_P, _P, _P, _P, _I, _I, _I, _P),
    # a, b, c, m, k, n, add_max, mult, stream
    "tropical_mm": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # starts, ta, tb, mslot, A, B, M, out, nout, is_float, stream
    "bsr_masked_mm": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # x, idx, out, R, Wx, L, stream
    "row_gather": (_P, _P, _P, _I, _I, _I, _P),
    # A, B, ai, bj, out, E, na, nb, S, blocks, stream
    "gatherdot_async": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

#: kernel launches per launcher since the last :func:`reset_launches`;
#: each wrapper adds one exactly where it launches its kernel
launches = {name: 0 for name in _SIGNATURES}

#: what the last build did: {"seconds", "library", "log"} (None when
#: the library was already built)
build_info = None

_LIB = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                       "the CUDA toolkit (set CUDA_HOME)")


def library() -> ctypes.CDLL:
    """The kernel library, built with nvcc when missing or stale."""
    global _LIB, build_info
    if _LIB is not None:
        return _LIB
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD / f"libgbtorch_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD.mkdir(exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        t0 = time.perf_counter()
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        # one compile per source, all in flight together, then one link;
        # on any failure the compiles still running are killed and every
        # object file is removed
        jobs = []
        log = []
        try:
            for src in (s for s in srcs if s.suffix == ".cu"):
                obj = BUILD / f"{src.stem}.{tag}.o"
                cmd = [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            for cmd, _, proc in jobs:
                _, err = proc.communicate()
                log.append(err)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{err}")
            cmd = [_nvcc(), "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, so)
        finally:
            for _, obj, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()
                obj.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
        build_info = {"seconds": time.perf_counter() - t0,
                      "library": str(so), "log": "".join(log)}
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, f"gb_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def launch(name: str, like: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` with ``args`` on PyTorch's current stream
    of ``like``'s device; raise if CUDA refused the launch."""
    fn = getattr(library(), f"gb_{name}")
    with torch.cuda.device(like.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")
    launches[name] += 1
