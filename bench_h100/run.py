"""Entry point: ``python3 bench_h100/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see
``harness.py``)."""

import os
import sys

if __name__ == "__main__":
    # import from the checkout's root, not from this folder (whose
    # sub-folders would shadow top-level modules of the same names)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from bench_h100.harness import main

    sys.exit(main())
