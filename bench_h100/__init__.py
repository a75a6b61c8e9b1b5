"""The benchmark of ``epcnet_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once:

  python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, traffic kind or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the model's sizes and the training settings;
- ``workloads/<cell>.json``: the cell's traffic kind, its parameters and the
  limits of its correctness check;
- ``traffic/<kind>.py``: one generator and window per kind of traffic
  (open-loop serving, closed-loop embedding, training steps);
- ``metrics/<metric>.py``: one reader per per-layer metric.

The yardstick lives here too: the plain fp32 reference (``reference/``),
the seeded inputs and weights (``data.py``, ``weights.py``), the FLOP and
byte counts with the card's peaks (``counts.py``) and the reading of the
profiler's trace (``trace.py``). Nothing here imports JAX or the JAX
package, and the reference imports nothing of ``epcnet_torch``.
"""
