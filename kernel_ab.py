"""Time the MVM legs and the iteration kernels of two checkouts of
clover_tpu_torch on one card.

    python3 kernel_ab.py OTHER_TREE
    python3 kernel_ab.py --sass OTHER_TREE

Runs OTHER_TREE (A) and this tree (B) in turns -- A, B, B, A -- each in a
fresh process that builds its own tree's kernels and times both legs of
the 8192x16384 IHT for mvm4 (4x4) and mvm8 (4x8, 8x8), and the
whole-iteration and chained (4 iterations) kernels of the 4096x8192 4x4
IHT, SR on, as chip_smoke.py's phase 2 does: the median of 5 windows of
20 back-to-back launches queued behind a spin kernel.  Prints the card,
one JSON line per run and, last, each kernel's mean time in A and B with
B's change.

With ``--sass`` it times nothing: it builds both trees' libraries and
compares the machine code (``cuobjdump -sass``) of every kernel, printing
for each whether A's and B's instructions are the same, differ, or exist
in one tree only.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

M, N = 8192, 16384
MU = 0.0002138596817016602      # the tuned 4-bit mu at this size
SMALL = (4096, 8192)            # the small path's iteration kernels
SMALL_MU = 0.0005050158681869508
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
    m, n = SMALL
    q = tt.quantize(phi[:m, :n].contiguous(), 4)
    ops = [(v.codes, v.scales) for v in (
        q, tt.transpose(q), tt.quantize(y[:m].contiguous(), 4),
        tt.quantize(xf[:n].contiguous(), 4))]
    out["iteration 4x4"] = median_ms(lambda: kn.iteration_cuda(
        4, 4, *ops, SMALL_MU, [1, 2, 3, 4], (True,) * 4))
    out["iteration_chain 4x4"] = median_ms(lambda: kn.iteration_chain_cuda(
        4, 4, *ops, SMALL_MU, n // 4, list(range(16)), (True,) * 4))
    print(json.dumps({"tree": tree, "ms": out}), flush=True)


LIBRARY_OF = """
import sys
sys.path.insert(0, sys.argv[1])
import clover_tpu_torch
from pathlib import Path
from clover_tpu_torch.kernels import _build
assert Path(clover_tpu_torch.__file__).resolve().is_relative_to(
    Path(sys.argv[1]).resolve())
print(_build.library().path)
"""
INSTRUCTION = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/")


def sass(tree: str) -> dict:
    """Kernel symbol -> its SASS instructions (``cuobjdump -sass``) in
    ``tree``'s library, built in a process of its own."""
    lib = subprocess.run([sys.executable, "-c", LIBRARY_OF, tree],
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout.strip().splitlines()[-1]
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bodies, name = {}, None
    for line in text.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name = found.group(1)
            bodies[name] = []
        elif name is not None and INSTRUCTION.match(line):
            bodies[name].append(line.strip())
    return bodies


def digest(body: list) -> tuple:
    return hashlib.sha256("\n".join(body).encode()).hexdigest()[:16], \
        len(body)


def show_diff(a_body: list, b_name: str, b_body: list) -> None:
    """How far A's kernel is from B's kernel ``b_name``: the count of
    differing instructions and the first of them."""
    import difflib
    lines = [x for x in difflib.unified_diff(a_body, b_body, lineterm="",
                                             n=0)
             if x[:1] in "+-" and x[:3] not in ("+++", "---")]
    print(f"    nearest in B: {b_name}: {len(lines)} lines differ")
    for x in lines[:12]:
        print(f"      {x[:110]}")


def compare_sass(trees: dict) -> None:
    """One line per kernel: same, DIFF, or only in A or B; a kernel of one
    tree only whose code equals a kernel of the other tree only (a
    template parameter added, say) is "renamed" and names it.  A DIFF, or
    a kernel of A left without a twin, is shown beside its nearest kernel
    of B."""
    import difflib
    bodies_a, bodies_b = sass(trees["A"]), sass(trees["B"])
    a = {k: digest(v) for k, v in bodies_a.items()}
    b = {k: digest(v) for k, v in bodies_b.items()}
    a_only = {a[k]: k for k in a if k not in b}
    b_only = {b[k]: k for k in b if k not in a}
    unmatched_b = [k for k in b if k not in a and b[k] not in a_only]
    tally = {}
    for name in sorted(set(a) | set(b)):
        nearest = None
        if name in a and name in b:
            verdict = "same" if a[name] == b[name] else "DIFF"
            nearest = name if verdict == "DIFF" else None
        elif name in b:
            twin = a_only.get(b[name])
            verdict = "only B" if twin is None else f"renamed from {twin}"
        else:
            if a[name] in b_only:
                continue                  # printed with its B twin
            verdict = "only A"
            nearest = max(unmatched_b, default=None, key=lambda k: (
                difflib.SequenceMatcher(None, bodies_a[name], bodies_b[k],
                                        autojunk=False).quick_ratio()))
        tally[verdict.split(" from ")[0]] = tally.get(
            verdict.split(" from ")[0], 0) + 1
        print(f"{verdict}: {name}  A {a.get(name)}  B {b.get(name)}")
        if nearest is not None:
            show_diff(bodies_a[name], nearest, bodies_b[nearest])
    print(f"{sum(tally.values())} kernels: " + ", ".join(
        f"{n} {v}" for v, n in sorted(tally.items())))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--sass":
        here = str(Path(__file__).resolve().parent)
        compare_sass({"A": str(Path(sys.argv[2]).resolve()), "B": here})
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
        print(f"{leg:20s} A {a:.4f} ms  B {b:.4f} ms  B/A - 1 = "
              f"{100 * (b / a - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
