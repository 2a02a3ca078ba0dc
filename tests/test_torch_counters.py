"""PyTorch port: per-op counters (mirror of ``test_counters.py``) —
``utils/counters.py``: op dispatch counts, the AxB engine histogram and
modelled flops, held against the JAX package's counts for the same
calls (op counts equal; the engine names map through
``jax_engine_name``)."""

import numpy as np

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.utils import counters as jcounters
from graphblas_tpu_torch.utils import counters

DEV = "cpu"


def _run(pkg, kw):
    rng = np.random.default_rng(0)
    D = (rng.random((8, 8)) < 0.4).astype(np.float64)
    A = pkg.Matrix.from_dense(D, pkg.FP64, pattern=D > 0, **kw)
    sr = pkg.semiring.plus_times[pkg.FP64]
    C = pkg.mxm(pkg.Matrix.new(pkg.FP64, 8, 8, **kw), None, None, sr, A, A)
    C = pkg.eWiseAdd(C, None, None, pkg.binary.plus[pkg.FP64], A, A)
    return pkg.reduce_to_scalar(None, pkg.monoid.plus[pkg.FP64], A)


def test_counters_track_ops_and_methods():
    counters.reset()
    jcounters.reset()
    got = _run(gt, {"device": DEV})
    want = _run(gb, {})
    assert got == want
    st, jst = counters.stats(), jcounters.stats()
    assert st["ops"].get("mxm") == 1
    assert st["ops"].get("eWiseAdd") == 1
    assert st["ops"].get("reduce_to_scalar") == 1
    assert sum(st["axb_methods"].values()) >= 1
    assert st["ops"] == jst["ops"]
    assert {gt.jax_engine_name(k): v for k, v in
            st["axb_methods"].items()} == jst["axb_methods"]


def test_counters_disable_and_reset():
    counters.reset()
    counters.enable(False)
    counters.bump("mxm")
    assert counters.stats()["ops"] == {}
    counters.enable(True)
    counters.bump("mxm", 3)
    assert counters.stats()["ops"]["mxm"] == 3
    counters.reset()
    assert counters.stats()["ops"] == {}
    assert counters.stats()["modelled_flops"] == 0
