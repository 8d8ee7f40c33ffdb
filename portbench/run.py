"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See portbench/harness/main.py.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.main import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], t_start=T_START))
