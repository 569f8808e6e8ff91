"""Time the MVM legs of two checkouts of clover_tpu_torch on one card.

    python3 kernel_ab.py OTHER_TREE

Runs OTHER_TREE (A) and this tree (B) in turns -- A, B, B, A -- each in a
fresh process that builds its own tree's kernels and times both legs of
the 8192x16384 IHT for mvm4 (4x4) and mvm8 (4x8, 8x8), SR on, as
chip_smoke.py's phase 2 does: the median of 5 windows of 20 back-to-back
launches queued behind a spin kernel.  Prints the card, one JSON line per
run and, last, each leg's mean time in A and B with B's change.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

M, N = 8192, 16384
MU = 0.0002138596817016602      # the tuned 4-bit mu at this size
SPIN_CYCLES = 1 << 23


def median_ms(fn, reps: int = 5, inner: int = 20) -> float:
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[reps // 2]


def child(tree: str) -> None:
    """Time the legs with the package of ``tree``; print one JSON line."""
    sys.path[0] = tree
    import torch
    import clover_tpu_torch as tt
    from clover_tpu_torch import kernels as kn
    if not Path(tt.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {tt.__file__}, not {tree}")
    kn._build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    phi = torch.rand(M, N, generator=gen, device="cuda") * 2 - 1
    y = torch.rand(M, generator=gen, device="cuda") * 2 - 1
    xf = torch.randn(N, generator=gen, device="cuda")
    out = {}
    for bits_a, bits_x in ((4, 4), (4, 8), (8, 8)):
        a = tt.quantize(phi, bits_a)
        at = tt.transpose(a)
        qy, qx = tt.quantize(y, bits_x), tt.quantize(xf, bits_x)
        mvm = (kn.mvm4_cuda if bits_x == 4 else
               (lambda *args, b=bits_a: kn.mvm8_cuda(b, *args)))
        leg1 = (a.codes, a.scales, qx.codes, qx.scales, qy.codes, qy.scales,
                -1.0, 1, True, 2, True)
        t2 = mvm(*leg1)
        leg2 = (at.codes, at.scales, *t2, qx.codes, qx.scales, MU, 1, True, 2,
                True)
        mode = f"mvm{bits_x} {bits_a}x{bits_x}"
        out[f"{mode} Phi"] = median_ms(lambda: mvm(*leg1))
        out[f"{mode} PhiT"] = median_ms(lambda: mvm(*leg2))
    print(json.dumps({"tree": tree, "ms": out}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = str(Path(__file__).resolve().parent)
    trees = {"A": str(Path(sys.argv[1]).resolve()), "B": here}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    runs = {"A": [], "B": []}
    for label in "ABBA":
        proc = subprocess.run([sys.executable, __file__, "--child",
                               trees[label]], capture_output=True, text=True,
                              check=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1]
        print(label, line, flush=True)
        runs[label].append(json.loads(line)["ms"])
    for leg in runs["A"][0]:
        a = sum(r[leg] for r in runs["A"]) / 2
        b = sum(r[leg] for r in runs["B"]) / 2
        print(f"{leg:14s} A {a:.4f} ms  B {b:.4f} ms  B/A - 1 = "
              f"{100 * (b / a - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
