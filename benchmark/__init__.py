"""The benchmark of the PyTorch and CUDA port (``cilium_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on a CUDA card
and prints one JSON result line.  See ``harness.py`` for how a cell's
files are found, ``drivers/`` for how a window drives the port,
``reference/`` and ``compare.py`` for how ``correct`` is decided, and
``trace.py`` with ``readers/`` for the per-layer metrics.
"""
