"""Run one cell of the benchmark:

    python bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is the result, one JSON object; the
numbers the output check compared are the last lines of standard error.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_torch import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
