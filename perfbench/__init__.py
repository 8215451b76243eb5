"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA device
and prints one JSON result line. Everything that belongs to one
configuration, traffic mix, per-layer metric or cell's limits sits in a
file of its own that the harness finds by name:

* ``configs/<config>.json`` — the pool as it is run, its source and cuts;
* ``traffic/<traffic>.json`` — the parameters of one mix, read by the one
  generator ``traffic/gen.py``;
* ``metrics/<metric>.py`` — a reader that takes one metric from a run's
  record (``reduce.py`` holds the shared arithmetic);
* ``limits/<cell>.json`` — the limits of the comparison that decides
  ``correct``, with the readings they were set from.

``reference/`` is the plain PyTorch reference (no kernel, no cache, f32)
that imports nothing of the port. ``sweep.py`` finds a chat cell's knee
and ``calibrate.py`` reads the comparison's numbers over many seeds and
its lower-precision control.
"""
