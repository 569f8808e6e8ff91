"""Command line (counterpart of clover_tpu/cli.py) with the ported modes:

    python -m clover_tpu_torch -v [--full] [--device cpu]
    python -m clover_tpu_torch -a [--gd] [--epochs N] [--no-sr] [--device cpu]

``-v`` validates every op against the golden oracle across size sweeps
(``--full``: the exhaustive sweep) and exits 1 when a check fails; ``-a``
runs the IHT accuracy protocol (all five precisions), ``--gd`` its GD
variant.  Both run on ``cuda`` unless ``--device`` asks for another.
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
    p.add_argument("-a", "--accuracy", action="store_true",
                   help="run the IHT accuracy protocol (all precisions)")
    p.add_argument("--full", action="store_true",
                   help="exhaustive size sweeps (validation)")
    p.add_argument("--gd", action="store_true",
                   help="use gradient descent instead of IHT")
    p.add_argument("--epochs", type=int, default=200,
                   help="accuracy-mode epochs (default 200)")
    p.add_argument("--no-sr", action="store_true",
                   help="disable stochastic rounding (deterministic mode)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.validate or args.accuracy):
        build_parser().print_help()
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("clover_tpu_torch: no CUDA device; pass --device cpu to run "
              "the kernels' plain versions", file=sys.stderr)
        return 2
    # the 16- and 32-bit MVMs and configurations multiply in fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .harness.sysinfo import print_banner
    print_banner(device)
    print()
    ok = True
    if args.validate:
        from .harness.validate import run_validation
        ok = run_validation(full=args.full, device=device)
    if args.accuracy:
        from .harness.accuracy import run_accuracy
        run_accuracy(epochs=args.epochs, sr=not args.no_sr, gd=args.gd,
                     device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
