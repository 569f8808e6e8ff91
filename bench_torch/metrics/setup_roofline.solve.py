"""Percent of the memory roofline that a solve's set-up reaches: the bytes
it needs (roofline.solve_setup_bytes) over the card's memory rate,
divided by the device time of the kernels launched inside the
``bench.solve.setup`` spans (quantize Phi and y, transpose Phi)."""

from bench_torch import roofline
from bench_torch.harness import precisions

SPAN = "bench.solve.setup"


def read(run):
    kernels = run.trace.kernels_in(SPAN)
    c = run.cell.config
    nbytes = run.trace.span_count(SPAN) * roofline.solve_setup_bytes(
        c["m"], c["n"], *precisions(c))
    seconds = sum(k.end - k.start for k in kernels) / 1e9
    return roofline.share_pct(nbytes, seconds,
                              roofline.memory_rate(run.device_name))
