"""Percent of the memory roofline that the IHT iterations reach: the bytes
they need (roofline.iteration_bytes per iteration, at the
configuration's matrix and vector precisions) over the card's memory
rate, divided by the device time of the kernels launched inside the
``bench.solve.iterate`` spans (the ``iht`` calls)."""

from bench_torch import roofline
from bench_torch.harness import precisions

SPAN = "bench.solve.iterate"


def read(run):
    kernels = run.trace.kernels_in(SPAN)
    c = run.cell.config
    iterations = run.trace.span_count(SPAN) * c["iterations"]
    nbytes = iterations * roofline.iteration_bytes(c["m"], c["n"],
                                                   *precisions(c))
    seconds = sum(k.end - k.start for k in kernels) / 1e9
    return roofline.share_pct(nbytes, seconds,
                              roofline.memory_rate(run.device_name))
