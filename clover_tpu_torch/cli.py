"""Command line (counterpart of clover_tpu/cli.py) with the reference's four
modes:

    python -m clover_tpu_torch -v [--full]         validation
    python -m clover_tpu_torch -p [--quick] [--sharded]   performance tables
    python -m clover_tpu_torch -a [--gd] [--epochs N] [--no-sr]   accuracy
    python -m clover_tpu_torch -g [--quick] [--gd | --mixed] [--ladder19]

``-v`` validates every op against the golden oracle across size sweeps
(``--full``: the exhaustive sweep) and exits 1 when a check fails; ``-p``
times every op against the card's memory rate and the probe floor; ``-a``
runs the IHT accuracy protocol (all five precisions), ``--gd`` its GD
variant; ``-g`` grid-searches the best (iterations, mu) per size for GD
pure, IHT pure, GD mixed and IHT mixed.  All run on ``cuda`` unless
``--device`` asks for another.
"""

from __future__ import annotations

import argparse
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clover_tpu_torch",
        description="block-scaled quantized linear algebra on PyTorch")
    p.add_argument("-v", "--validate", action="store_true",
                   help="validate the ops against the golden oracle across "
                        "size sweeps")
    p.add_argument("-p", "--performance", action="store_true",
                   help="run the performance benchmark tables")
    p.add_argument("-a", "--accuracy", action="store_true",
                   help="run the IHT accuracy protocol (all precisions)")
    p.add_argument("-g", "--grid-search", action="store_true",
                   help="hyper-parameter grid search (best mu/iterations)")
    p.add_argument("--full", action="store_true",
                   help="exhaustive size sweeps (validation)")
    p.add_argument("--quick", action="store_true",
                   help="reduced size set (performance / search)")
    p.add_argument("--sharded", action="store_true",
                   help="-p: bench the sharded path over the running "
                        "world's mesh (1x1 in one process, R x C under "
                        "torchrun)")
    p.add_argument("--gd", action="store_true",
                   help="use gradient descent instead of IHT (-a; restricts "
                        "-g to the GD families)")
    p.add_argument("--mixed", action="store_true",
                   help="restrict -g to the mixed 4x8 families (default "
                        "runs all four)")
    p.add_argument("--ladder19", action="store_true",
                   help="use the reference's full 19-size ladder for -g "
                        "(default: 12 sizes, 256..32768)")
    p.add_argument("--epochs", type=int, default=200,
                   help="accuracy-mode epochs (default 200)")
    p.add_argument("--no-sr", action="store_true",
                   help="disable stochastic rounding (deterministic mode)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda)")
    return p


def _print_search(results) -> None:
    for kind, rows in results.items():
        print(f"\n=== {kind} ===")
        print(f"{'bits':>5} {'m':>8} {'n':>8} {'K':>8} "
              f"{'iters':>6} {'mu':>14} {'target':>10}")
        for row in rows:
            for bits, col in row["cols"].items():
                it, mu = col if col else ("-", float("nan"))
                print(f"{bits:>5} {row['m']:>8} {row['n']:>8} "
                      f"{row['K']:>8} {it:>6} {mu:>14.8f} "
                      f"{row['quality_target']:>10.6f}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.validate or args.performance or args.accuracy
            or args.grid_search):
        build_parser().print_help()
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("clover_tpu_torch: no CUDA device; pass --device cpu to run "
              "the kernels' plain versions", file=sys.stderr)
        return 2
    # the 16- and 32-bit MVMs and configurations, and -p's fp32 baselines,
    # multiply in fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .harness.sysinfo import print_banner
    print_banner(device)
    print()
    ok = True
    if args.validate:
        from .harness.validate import run_validation
        ok = run_validation(full=args.full, device=device)
    if args.performance:
        from .harness.perf import run_perf
        run_perf(quick=args.quick, sharded=args.sharded, device=device)
    if args.accuracy:
        from .harness.accuracy import run_accuracy
        run_accuracy(epochs=args.epochs, sr=not args.no_sr, gd=args.gd,
                     device=device)
    if args.grid_search:
        # GD pure, IHT pure, GD mixed, IHT mixed in one invocation, each
        # with all four precision columns per size
        from .harness.search import (
            SEARCH_SIZES_FULL, SIZE_LADDER, run_search_full)
        kinds = [k for k in ("gd", "iht", "gd_mixed", "iht_mixed")
                 if (not args.gd or k.startswith("gd"))
                 and (not args.mixed or k.endswith("mixed"))]
        sizes = SIZE_LADDER if args.ladder19 else SEARCH_SIZES_FULL
        if args.quick:
            sizes = sizes[:2]
        _print_search(run_search_full(sizes=sizes, kinds=tuple(kinds),
                                      log=lambda *a: None, device=device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
