"""Run one cell of the benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program.  See README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.run(sys.argv[1:], T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
