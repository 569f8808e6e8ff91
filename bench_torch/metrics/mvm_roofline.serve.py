"""Percent of the memory roofline that the server's single-vector products
reach (a batch of one request runs ``mvm_kernel``): per launch the matrix
read once, the vector read and the result written
(roofline.mvm_batch_bytes with one vector), over the card's memory rate,
divided by the device time of those launches."""

from bench_torch import roofline

KERNEL = "::mvm_kernel<"


def read(run):
    kernels = [k for k in run.trace.kernels() if KERNEL in k.name]
    if not kernels:
        return None
    c = run.cell.config
    nbytes = len(kernels) * roofline.mvm_batch_bytes(c["m"], c["n"],
                                                      c["bits"], 1)
    seconds = sum(k.end - k.start for k in kernels) / 1e9
    return roofline.share_pct(nbytes, seconds,
                              roofline.memory_rate(run.device_name))
