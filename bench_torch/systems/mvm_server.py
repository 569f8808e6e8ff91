"""The served-MVM configurations: the program's ``MVMServer`` answering
matrix-vector products against one resident quantized matrix.

Set-up: A ~ U(-1, 1), m x n, made on the card from ``--seed`` and quantized
by the program with stochastic rounding; a pool of ``pool`` request
vectors ~ U(-1, 1), each quantized by the program with stochastic
rounding; the server started with the configuration's settings.  A
request submits one vector of the pool, waits for its future and copies
the result's codes and scales to the host: only then is it complete (the
server resolves a future before its batched MVM has run on the device).

The check: the relative error ||y - A v|| / ||A v|| of each sampled
answer, decoded on the host from its codes and scales, against that of
the plain reference's product of its own stochastic roundings of A and v,
with A v the exact product of the unquantized operands.
"""

from __future__ import annotations

import torch

from bench_torch import reference
from bench_torch.harness import derive


def _generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, what))


def make_matrix(m: int, n: int, seed: int, device) -> torch.Tensor:
    a = torch.empty(m, n, device=device)
    return a.uniform_(-1.0, 1.0, generator=_generator(seed, "a", device))


def make_vectors(pool: int, n: int, seed: int, device) -> torch.Tensor:
    v = torch.empty(pool, n, device=device)
    return v.uniform_(-1.0, 1.0, generator=_generator(seed, "v", device))


class Load:
    keys = 0                      # the requests carry no seed

    def __init__(self, config: dict, traffic: dict, seed: int, device, span):
        import clover_tpu_torch as tt
        from clover_tpu_torch.serving import MVMServer
        self.span, self.seed = span, seed
        self.m, self.n, self.bits = config["m"], config["n"], config["bits"]
        self.device = torch.device(device)
        self.pool = traffic["pool"]
        sr = derive(seed, "sr")
        a = make_matrix(self.m, self.n, seed, self.device)
        self.qa = tt.quantize_mat(a, self.bits, generator=sr & 0xFFFFFFFF)
        del a
        v = make_vectors(self.pool, self.n, seed, self.device)
        self.requests = [tt.quantize_vec(v[j], self.bits,
                                         generator=(sr + 1 + j) & 0xFFFFFFFF)
                         for j in range(self.pool)]
        server = config["server"]
        self.server = MVMServer(self.qa, max_batch=server["max_batch"],
                                max_wait_s=server["max_wait_s"])

    def start(self, index: int, keys: tuple):
        with self.span("bench.client.submit"):
            return self.server.submit(self.requests[index])

    def finish(self, future):
        with self.span("bench.client.wait"):
            y = future.result(timeout=60)
        with self.span("bench.client.read"):
            return (y.codes.cpu(), y.scales.cpu()), 1

    def close(self):
        """Stop the server and free the program's state."""
        self.server.close()
        del self.server, self.qa, self.requests

    # -- the reference ---------------------------------------------------------

    def reference_answers(self, samples: list, precision: tuple,
                          label: str) -> list:
        """The reference's products of the samples' vectors, A at
        ``precision[0]`` bits, the vectors and products at
        ``precision[1]``."""
        bits, vector_bits = precision
        a = make_matrix(self.m, self.n, self.seed, self.device)
        a_q = reference.quant_mat(
            a, bits, _generator(self.seed, f"{label}/a", self.device))
        del a
        v = make_vectors(self.pool, self.n, self.seed, self.device)
        idx = torch.tensor([s.index for s in samples], device=self.device)
        x_q = reference.quant_vec(
            v[idx], vector_bits,
            _generator(self.seed, f"{label}/v", self.device))
        y = reference.mvm(a_q, x_q.T, vector_bits).T.cpu()
        return list(y)

    def _exact(self) -> torch.Tensor:
        """A v for every vector of the pool, unquantized, f32 [pool, m]."""
        if not hasattr(self, "_z"):
            a = make_matrix(self.m, self.n, self.seed, self.device)
            v = make_vectors(self.pool, self.n, self.seed, self.device)
            with reference.ieee_fp32():
                self._z = (a.double() @ v.double().T).T.float()
        return self._z

    def error(self, answer, sample) -> float:
        if isinstance(answer, tuple):
            answer = reference.restore4(*answer, self.m)
        return reference.rel_error(answer.to(self.device),
                                   self._exact()[sample.index])
