"""Run one benchmark cell:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card.  The last line on standard
output is the result, one JSON object; the last lines on standard error
are the numbers compared against the plain reference, each beside its
limit.  See benchmark/README.md.
"""

import os
import sys
import time

if __name__ == "__main__":
    _t_import = time.time()
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, _root)
    from benchmark import harness
    harness.setup_environment()
    try:
        _t0 = harness.process_start()
    except (OSError, ValueError, StopIteration):
        _t0 = _t_import
    sys.exit(harness.main(sys.argv[1:], t0=_t0))
