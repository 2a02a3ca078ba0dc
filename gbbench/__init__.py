"""gbbench: the benchmark of graphblas_tpu_torch on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 gbbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The harness is driven by data.  A cell names a configuration
(``configs/<config>.json``, whose ``graph`` names the generator
``graphs/<graph>.py``) and a traffic mix (``traffic/<traffic>.json``,
whose ``entry`` names ``entries/<entry>.py``: it hands the benchmark's
inputs to the port and makes the timed call).  ``reference/<entry>.py``
is the entry's plain reference, ``roofline/<entry>.py`` its compulsory
bytes, and each metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``.  A configuration's file also gives the sizes
the benchmark's own tests run it at (``test_sizes`` on the CPU, and
where they differ ``card_test_sizes`` and ``control_test_sizes``).  A
new cell, configuration or per-layer metric is new files and entries,
with no edit to a file that is here.

Nothing in this package imports JAX or the JAX package, and the
references import nothing of ``graphblas_tpu_torch``.
"""
