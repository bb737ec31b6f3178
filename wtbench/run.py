"""Run one cell of the benchmark once and print its result line.

    python3 wtbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with an NVIDIA GPU.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``wtbench/configs/<config>.json``) and a traffic mix
(``wtbench/traffic/<traffic>.json``), whose ``entry`` names the module
that drives the program (``wtbench/entries/<entry>.py``).  Set-up makes the inputs from the seed and
warms every shape; the window drives ``worldtpu_torch`` for S seconds;
then the outputs are compared with the plain reference
(``wtbench/reference``).  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``); the numbers compared, each with its
limit, are the last lines of standard error.
"""

import os
import sys


def process_age_s():
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


#: host threads of the measured process (the card's host is shared)
THREADS = "4"


def main():
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = THREADS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the checkout's root in place of this directory, whose module names
    # (trace, ...) would shadow the standard library's
    sys.path[0] = root
    from wtbench import harness
    return harness.main(sys.argv[1:], root, process_age_s)


if __name__ == "__main__":
    sys.exit(main())
