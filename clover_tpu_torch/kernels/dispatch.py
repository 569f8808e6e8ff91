"""Dispatch policy and SR seeds.

One rule: tensors on a CUDA device go to the hand-written kernel, tensors
on the CPU go to the kernel's plain torch version.  There is no switch
that sends a CUDA tensor anywhere else; a kernel that cannot build or
launch raises.
"""

from __future__ import annotations

import torch

# Large odd constants for deriving per-op SR seed streams by integer
# arithmetic, wrapped to int32 as in clover_tpu/kernels/dispatch.py.
SEED_GOLD = -1640531527           # 0x9E3779B9 as int32 (golden-ratio mix)
SEED_OP = 40503                   # per-op stride within an iteration


def wrap_i32(v: int) -> int:
    """Python int -> int32 with two's-complement wrap-around."""
    return (int(v) + (1 << 31)) % (1 << 32) - (1 << 31)


def seed_from(generator) -> tuple[int, bool]:
    """Normalize an SR randomness argument to ``(int32 seed, noise)``.

    Accepts None (deterministic), a Python int (a seed carried through a
    solver loop) or a ``torch.Generator``, from which one int is drawn on
    the host.
    """
    if generator is None:
        return 0, False
    if isinstance(generator, int):
        return wrap_i32(generator), True
    if isinstance(generator, torch.Generator):
        draw = torch.randint(-(1 << 31), 1 << 31, (1,), dtype=torch.int64,
                             generator=generator, device=generator.device)
        return wrap_i32(int(draw)), True
    raise TypeError(f"expected None, int or torch.Generator, "
                    f"got {type(generator).__name__}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every
    tensor is on the CPU; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")
