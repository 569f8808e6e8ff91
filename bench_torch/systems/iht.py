"""The IHT configurations: compressive-sensing recovery with the program's
quantized IHT solve, as a user writes it: Phi at the configuration's
``bits``, y at its ``vector_bits`` (``bits`` where it states none); the
program's x starts at y's precision, so a 4-bit Phi with 8-bit vectors
runs the program's mixed 4x8 path.

The inputs follow the upstream problem recipe (Clover
test/performance/03_iht_gd_util.cpp:449-495): Phi ~ U(-1, 1), each x* a
random K-sparse 0/1 vector, y = Phi x*; made on the card from ``--seed``
(a pool of ``pool`` (x*, y) pairs).  A request recovers one x from one y
of the pool, and is complete when x's values are on the host:

- traffic ``"phi": "per_request"``: quantize Phi (stochastic rounding, a
  fresh seed each solve) and y, transpose Phi, ``iht`` (deterministic
  iterations, as the tuned mu assume), restore x and copy it to the host;
- traffic ``"phi": "resident"``: Phi quantized and transposed once in
  set-up; a request quantizes its y, solves, restores and copies x.

The SR seeds reach the program as Python ints: a CUDA ``torch.Generator``
would make the program draw its seed on the device and wait for it.

The check: the relative recovery error ||x - x*|| / ||x*|| of each sampled
answer against that of the plain reference's solve of the same y, with
its own stochastic rounding of Phi and y.
"""

from __future__ import annotations

import torch

from bench_torch import reference
from bench_torch.harness import derive, precisions


def _generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, what))


def make_phi(m: int, n: int, seed: int, device) -> torch.Tensor:
    phi = torch.empty(m, n, device=device)
    return phi.uniform_(-1.0, 1.0, generator=_generator(seed, "phi", device))


def make_problems(phi: torch.Tensor, k: int, pool: int, seed: int):
    """-> (x* f32[pool, n], y f32[pool, m])."""
    m, n = phi.shape
    gen = _generator(seed, "x_star", phi.device)
    x_star = torch.zeros(pool, n, device=phi.device)
    for j in range(pool):
        x_star[j, torch.randperm(n, generator=gen, device=phi.device)[:k]] = 1
    with reference.ieee_fp32():
        y = (phi @ x_star.T).T.contiguous()
    return x_star, y


class Load:
    keys = 2                      # SR seeds per request: Phi's and y's

    def __init__(self, config: dict, traffic: dict, seed: int, device, span):
        import clover_tpu_torch as tt
        self.tt, self.span, self.seed = tt, span, seed
        self.m, self.n = config["m"], config["n"]
        self.k, self.mu = config["K"], config["mu"]
        self.iterations = config["iterations"]
        self.bits, self.vector_bits = precisions(config)
        self.per_request = traffic["phi"] == "per_request"
        self.device = torch.device(device)
        phi = make_phi(self.m, self.n, seed, self.device)
        self.x_star, self.y = make_problems(phi, self.k, traffic["pool"],
                                            seed)
        if self.per_request:
            self.phi = phi
        else:
            self.qphi = tt.quantize_mat(
                phi, self.bits, generator=derive(seed, "phi_sr") & 0xFFFFFFFF)
            self.qphit = tt.transpose(self.qphi)
            del phi
        self._ref_phi = {}

    def start(self, index: int, keys: tuple):
        """Queue one solve on the device; -> x's values there."""
        tt, span = self.tt, self.span
        if self.per_request:
            with span("bench.solve.setup"):
                qphi = tt.quantize_mat(self.phi, self.bits, generator=keys[0])
                qy = tt.quantize_vec(self.y[index], self.vector_bits,
                                     generator=keys[1])
                qphit = tt.transpose(qphi)
        else:
            qphi, qphit = self.qphi, self.qphit
            with span("bench.solve.quantize_y"):
                qy = tt.quantize_vec(self.y[index], self.vector_bits,
                                     generator=keys[1])
        with span("bench.solve.iterate"):
            res = tt.iht(qphi, qphit, qy, self.iterations, self.k, self.mu)
        with span("bench.solve.restore"):
            return tt.restore_vec(res.x).values[:self.n]

    def finish(self, x):
        """x's values on the host."""
        with self.span("bench.solve.read"):
            return x.cpu(), self.iterations

    def close(self):
        """Free the program's state; keep the inputs the reference needs."""
        for name in ("phi", "qphi", "qphit"):
            self.__dict__.pop(name, None)

    # -- the reference ---------------------------------------------------------

    def _reference_phi(self, bits: int, label: str, j: int):
        """The reference's own quantized Phi: one per sample when each
        request quantizes Phi, else one for every sample."""
        key = (bits, label, j if self.per_request else 0)
        if key not in self._ref_phi:
            self._ref_phi.clear()
            phi = make_phi(self.m, self.n, self.seed, self.device)
            gen = _generator(self.seed, f"{label}/phi/{key}", self.device)
            self._ref_phi[key] = reference.quant_mat(phi, bits, gen)
        return self._ref_phi[key]

    def reference_answers(self, samples: list, precision: tuple,
                          label: str) -> list:
        """The reference's solves of the samples' y, Phi at
        ``precision[0]`` bits, y, t2 and x at ``precision[1]``."""
        bits, vector_bits = precision
        out = []
        for j, s in enumerate(samples):
            phi_q = self._reference_phi(bits, label, j)
            gen = _generator(self.seed, f"{label}/y/{j}", self.device)
            y_q = reference.quant_vec(self.y[s.index], vector_bits, gen)
            out.append(reference.iht(phi_q, y_q, self.iterations, self.k,
                                     self.mu, vector_bits).cpu())
        self._ref_phi.clear()
        return out

    def error(self, answer: torch.Tensor, sample) -> float:
        return reference.rel_error(answer.to(self.device),
                                   self.x_star[sample.index])
