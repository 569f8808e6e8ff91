"""95th percentile, by the host clock, of every whole solve started in the
window: from the f32 inputs on the card to x's values on the host."""

from bench_torch.harness import percentile


def read(run):
    lat = run.latencies_ms()
    return percentile(lat, 95) if lat else None
