"""Command line (counterpart of clover_tpu/cli.py) with the ported mode:

    python -m clover_tpu_torch -a [--gd] [--epochs N] [--no-sr] [--device cpu]

``-a`` runs the IHT accuracy protocol (all five precisions), ``--gd`` its
GD variant.  It runs on ``cuda`` unless ``--device`` asks for another.
"""

from __future__ import annotations

import argparse
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clover_tpu_torch",
        description="block-scaled quantized linear algebra on PyTorch")
    p.add_argument("-a", "--accuracy", action="store_true",
                   help="run the IHT accuracy protocol (all precisions)")
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
    if not args.accuracy:
        build_parser().print_help()
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("clover_tpu_torch: no CUDA device; pass --device cpu to run "
              "the kernels' plain versions", file=sys.stderr)
        return 2
    # the 16- and 32-bit configurations multiply in fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .harness.accuracy import run_accuracy
    from .harness.sysinfo import print_banner
    print_banner(device)
    print()
    run_accuracy(epochs=args.epochs, sr=not args.no_sr, gd=args.gd,
                 device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
