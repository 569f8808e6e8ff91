"""The closed loop: ``clients`` clients, all driven from this one thread;
each sends a request drawn from the pool by a random sequence of its own
seeded from ``seed``, waits for the answer on the host and sends the next,
until the window closes.  Answers are awaited in the order the requests
were sent.  Each client keeps a uniform sample of its answers (reservoir
sampling, seeded the same way).

Traffic keys: ``clients``, ``pool`` (the inputs a request draws from),
``sample`` (answers kept for the check, over all clients) and ``warmup``
(requests each client sends before the window).

One thread keeps the load's own host cost small and steady: client
threads would contend with the program's threads for the interpreter
lock.  The system module splits a request into ``start(index, keys)``,
which sends it, and ``finish(pending) -> (answer, units)``, which waits
for its answer on the host.
"""

from __future__ import annotations

import array
import collections
import math
import random
import time

from bench_torch.harness import Record, Sample, derive


class Generator:

    def __init__(self, load, traffic: dict, seed: int):
        self.load, self.seed = load, seed
        self.clients = int(traffic["clients"])
        self.pool = int(traffic["pool"])
        self.warmup = int(traffic["warmup"])
        self.keep = math.ceil(int(traffic["sample"]) / self.clients)
        self._phase = 0

    def warm(self):
        """``warmup`` requests from each client; a failed one raises."""
        _, _, errors, _, _ = self.run(per_client=self.warmup)
        if errors:
            raise RuntimeError(f"warm-up failed: {errors[0]}")

    def run(self, seconds: float | None = None, per_client: int | None = None):
        """Drive the load for ``seconds`` or ``per_client`` requests each;
        -> (records, samples, errors, start, deadline).  Requests sent
        before the deadline are waited for."""
        self._phase += 1
        load, n = self.load, self.clients
        draw = [random.Random(derive(self.seed, "draw", self._phase, c))
                for c in range(n)]
        pick = [random.Random(derive(self.seed, "sample", self._phase, c))
                for c in range(n)]
        sent = [0] * n
        samples = [[] for _ in range(n)]
        errors: list = []
        # arrays, which the garbage collector does not scan, while the
        # window runs
        cols = (array.array("q"), array.array("d"), array.array("d"),
                array.array("q"), array.array("b"))
        pending = collections.deque()
        start = time.perf_counter()
        deadline = start + (seconds or 0.0)

        def send(c):
            index = draw[c].randrange(self.pool)
            keys = tuple(draw[c].getrandbits(32) for _ in range(load.keys))
            t0 = time.perf_counter()
            try:
                handle = load.start(index, keys)
            except Exception as e:       # a failed request counts as failed
                handle = e
            pending.append((c, index, t0, handle))
            sent[c] += 1

        for c in range(n):
            send(c)
        while pending:
            c, index, t0, handle = pending.popleft()
            try:
                if isinstance(handle, Exception):
                    raise handle
                answer, units = load.finish(handle)
                ok = True
            except Exception as e:
                answer, units, ok = None, 0, False
                errors.append(f"client {c}: {type(e).__name__}: {e}")
            t1 = time.perf_counter()
            for column, value in zip(cols, (c, t0, t1, units, ok)):
                column.append(value)
            if ok:
                mine = samples[c]
                if len(mine) < self.keep:
                    mine.append(Sample(index, answer))
                else:
                    j = pick[c].randrange(sent[c])
                    if j < self.keep:
                        mine[j] = Sample(index, answer)
            if (sent[c] < per_client if per_client is not None
                    else t1 < deadline):
                send(c)
        return ([Record(*r) for r in zip(*cols)],
                [s for ss in samples for s in ss], errors, start, deadline)
