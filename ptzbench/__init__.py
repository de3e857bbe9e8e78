"""The benchmark of ``ptzjax_torch`` on an NVIDIA H100: one run of one
cell (a configuration under a traffic mix) per process, driven by
``BENCHMARK.json`` and the data files under this folder.

    python3 -m ptzbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell's limits is a file of its own, found by its name (``registry.py``).
The yardstick (``frames.py``, ``generator.py``, ``roofline.py``,
``check.py``, ``reference/``) imports nothing of ``jax`` or ``ptzjax``; only
``program.py`` imports the program, ``ptzjax_torch`` (``faults.py``, which
plants faults in it for the tests and ``calibrate.py``, through it).
"""
