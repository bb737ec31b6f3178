"""The benchmark of ``worldtpu_torch`` on an NVIDIA H100: run one cell with
``python3 wtbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
(see ``run.py`` and ``harness.py``)."""
