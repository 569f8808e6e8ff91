"""``-a`` accuracy mode: the reference's solver-quality protocol -- IHT at
m=512, n=1024, K=64 for 200 epochs at per-precision tuned mu, printing the
relative recovery error every ``every`` epochs for all five precision
configurations -- or its GD variant (counterpart of
clover_tpu/harness/accuracy.py, same printed lines)."""

from __future__ import annotations

import torch

from ..models.accuracy import (
    ACCURACY_MU, GD_MU, run_gd_accuracy, run_iht_accuracy,
)

CONFIGS = ["4x8", 4, 8, 16, 32]


def run_accuracy(epochs: int = 200, every: int = 10, sr: bool = True,
                 gd: bool = False, device=None, log=print):
    """Run all five precision configurations on ``device`` (default
    ``cuda``); -> {config: trace as a NumPy array}.  With ``sr`` each
    configuration draws its SR seeds from a CPU generator seeded 0."""
    out = {}
    for cfg in CONFIGS:
        generator = torch.Generator().manual_seed(0) if sr else None
        name = cfg if isinstance(cfg, str) else f"{cfg}-bit"
        log(f"=== {'GD' if gd else 'IHT'} accuracy: {name} "
            f"(mu={GD_MU if gd else ACCURACY_MU[cfg]:.8f}) ===")
        if gd:
            trace = run_gd_accuracy(cfg, iterations=epochs,
                                    generator=generator, device=device)
        else:
            trace = run_iht_accuracy(cfg, epochs=epochs, generator=generator,
                                     device=device)
        trace = trace.cpu().numpy()
        for i in range(0, len(trace), every):
            log(f"  epoch {i + 1:4d}: ||x - x*|| / ||x*|| = {trace[i]:.6f}")
        log(f"  final: {trace[-1]:.6f}")
        out[cfg] = trace
    return out
