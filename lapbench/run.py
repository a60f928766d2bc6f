"""Run one cell of the benchmark of ``sslap_tpu_torch`` on this machine's
cards and print one JSON line.

    python3 lapbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  See ``lapbench/README.md``."""

import time

T_START = time.perf_counter()   # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, so that ``lapbench`` and the program import.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lapbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
