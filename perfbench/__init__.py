"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one cell, configuration or per-layer
metric sits in a file of its own, found by its name:

* ``configs/<config>.json``   a configuration as it is run;
* ``workloads/<cell>.json``   a cell: its driver and traffic parameters;
* ``metrics/<metric>.py``     a per-layer metric's reader (``MOVES``,
  ``read(ctx)``);
* ``drivers/<driver>.py``     one driver per kind of cell (a simulator
  sweep, a serving engine);
* ``reference/``              the plain references, the operation and
  byte counts, and the peaks: the yardstick, which imports nothing of
  the program.
"""
