"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

One command runs one cell once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell, configuration or per-layer metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the deployment's sizes, tuning and source
  (and, optionally, ``"cpu_test"``: the sizes its CPU tests keep, where
  its driver's would lose its shape);
* ``workloads/<cell>.json``: the cell's configuration, traffic driver,
  traffic parameters and the limits of its correctness check;
* ``traffic/<driver>.py``: a general generator and timed loop that reads
  those parameters (``fits``: back-to-back distributed fits; ``serving``:
  sessions of a seed fit and a tick epoch of classify, ingest and refresh);
* ``layer_metrics/<metric>.py``: a reader that takes one per-layer
  metric from a traced run (:class:`portbench.trace.Trace`).

The yardstick lives here too: the two-class sampler (``sampler.py``),
the frozen work counts and peaks (``work.py``), the trace reduction
(``trace.py``), and the plain reference with its lower-precision control
(``reference/``), which imports nothing of the port.
"""
