"""The readings the output check's limits are set from, at a cell's own size:

    python bench_torch/control.py --workload <cell> --seeds 11 12 13 --seconds 2

For each seed, in one process: the cell's set-up and a short window of the
program, the largest gap of its sampled answers (the program's reading);
then the control, the plain reference computed at the control's
precisions (``harness.control_precisions``: the configuration's
``control``, else one precision below its own) in the program's place,
on the same sampled requests (the control's reading).  One JSON line per
seed.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_torch import harness
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, load, samples, errors, _ = harness.measure(
            cell, seed, args.seconds, False, t0)
        load.close()
        program = harness.gaps(load, samples, cell.config)
        control = harness.gaps(
            load, samples, cell.config,
            harness.control_answers(load, samples, cell.config))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "answers": len(samples), "failed": len(errors),
                          "program": max(program), "control": min(control),
                          "program_all": program, "control_all": control}),
              flush=True)
        del load, run, samples
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
