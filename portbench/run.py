"""One run of one benchmark cell of the port (brax_tracking_tpu_torch):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # the checkout's root on the path, this folder off it (its module names
    # are the package's, not top-level ones)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
