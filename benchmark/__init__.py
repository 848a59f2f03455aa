"""The benchmark of ``tpu_inspect_torch`` on one CUDA card.

One command runs one cell once and prints one JSON result line::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are data:
``BENCHMARK.json`` at the repository's root names them, and the harness
finds each by that name (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``); a mix names its kind, ``traffic/<kind>.py``. ``reference/`` is the plain restatement of the
inspection tool's OpenCV chain that decides ``correct``; it imports nothing
of the port.
"""
