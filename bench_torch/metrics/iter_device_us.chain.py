"""Device microseconds per IHT iteration: the device time of the kernels
launched inside the ``bench.solve.iterate`` spans (the ``iht`` calls),
over the iterations of those solves.  It reads the same work whatever
carries it: chains of any length, whole-iteration or unfused kernels.

No roofline share: Phi and PhiT (16.8 MB each at 4096x8192) stay in the
50 MB L2 for the whole solve, so a count of their bytes per iteration over
the HBM rate is no bound a sound chain must stay under (it could read above
100%), and each input counted once a solve makes a share of under 1% that
says nothing; the L2's rate has no data-sheet figure."""

SPAN = "bench.solve.iterate"


def read(run):
    kernels = run.trace.kernels_in(SPAN)
    iterations = run.trace.span_count(SPAN) * run.cell.config["iterations"]
    if not kernels or not iterations:
        return None
    return sum(k.end - k.start for k in kernels) / 1e3 / iterations
