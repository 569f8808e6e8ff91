"""Problem generators for the solvers (counterpart of
clover_tpu/models/problems.py).

IHT: Phi ~ U(-1, 1), x* a random K-sparse 0/1 vector, y = Phi x*.  The
data is made where the generator lives, so a CUDA generator builds a
full-size problem on the card without a host round trip.
"""

from __future__ import annotations

import torch

DEFAULT_SEED = 445560390295639063 % (2 ** 32)


def make_iht_problem(m: int, n: int, k: int,
                     generator: torch.Generator | None = None):
    """-> (Phi f32[m, n], x_star f32[n], y f32[m]) on the generator's
    device; ``generator=None`` uses a CPU generator seeded with
    ``DEFAULT_SEED``."""
    if generator is None:
        generator = torch.Generator().manual_seed(DEFAULT_SEED)
    device = generator.device
    phi = torch.rand(m, n, generator=generator, device=device) * 2 - 1
    x = torch.zeros(n, device=device)
    x[torch.randperm(n, generator=generator, device=device)[:k]] = 1.0
    return phi, x, phi @ x
