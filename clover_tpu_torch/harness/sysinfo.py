"""System banner (counterpart of clover_tpu/harness/sysinfo.py): Python,
torch and CUDA versions, the device, its power limit as nvidia-smi reads
it, its HBM rate from the data sheet, and the fp32 matmul mode."""

from __future__ import annotations

import platform
import subprocess
import sys

import torch

# HBM bytes/s by device name (NVIDIA data sheets); the first match wins.
HBM_SPEC = (("H100 PCIe", 2.0e12), ("H100", 3.35e12), ("H200", 4.8e12))


def hbm_spec(name: str) -> float | None:
    """The data sheet's memory rate for a device name, or None."""
    return next((rate for key, rate in HBM_SPEC if key in name), None)


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def banner(device) -> str:
    device = torch.device(device)
    lines = [
        "clover_tpu_torch — block-scaled quantized linear algebra on "
        "PyTorch, hand-written CUDA kernels for Hopper",
        f"python   : {sys.version.split()[0]} on {platform.platform()}",
        f"torch    : {torch.__version__}, CUDA {torch.version.cuda}",
    ]
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        rate = hbm_spec(name)
        lines += [
            f"device   : {name} ({torch.cuda.device_count()} visible)",
            f"card     : {nvidia_smi()} (nvidia-smi name, power limit)",
            "memory   : " + (f"HBM {rate / 1e12:.2f} TB/s (data sheet)"
                             if rate else "HBM rate unknown for this name"),
        ]
    else:
        lines.append(f"device   : {device} (the kernels' plain versions)")
    lines.append(f"matmul   : fp32 TF32 "
                 f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}"
                 f" (torch.backends.cuda.matmul.allow_tf32)")
    return "\n".join(lines)


def print_banner(device):
    print(banner(device))
