"""clover_tpu_torch.harness.timing and .profile against clover_tpu's
formulas (harness/timing.py gbs and pct_roofline), with the card's
data-sheet rate in place of the TPU's."""

import math
import time

import pytest
import torch

from clover_tpu.harness import profile as jax_profile
from clover_tpu.harness import timing as jax_timing
from clover_tpu_torch.harness import profile, timing
from clover_tpu_torch.harness.sysinfo import hbm_spec

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("nbytes,dt", [(1 << 20, 1e-3), (67_108_864, 2e-5),
                                       (12, 3e-9)])
def test_gbs_and_pct_roofline_follow_the_reference(nbytes, dt):
    assert timing.gbs(nbytes, dt) == jax_timing.gbs(nbytes, dt)
    # the reference's formula, 100 * bytes / dt / rate, at the H100's rate
    rate = hbm_spec(H100)
    assert rate == 3.35e12
    assert timing.pct_roofline(nbytes, dt, H100) == pytest.approx(
        jax_timing.pct_roofline(nbytes, dt) * jax_timing.HBM_BYTES_PER_S
        / rate, rel=1e-12)
    assert timing.pct_roofline(nbytes, dt, H100) == 100.0 * nbytes / dt / rate


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                                  "cpu"])
def test_unknown_device_raises(name):
    with pytest.raises(ValueError):
        timing.pct_roofline(1 << 20, 1e-3, name)
    with pytest.raises(ValueError):
        timing.memory_rate(torch.device("cpu"))


def test_constants_kept():
    assert timing.MEASURE_REPETITIONS == jax_timing.MEASURE_REPETITIONS == 7
    assert not hasattr(timing, "BF16_FLOPS")
    assert timing.HOST_SPIN_CYCLES > timing.SPIN_CYCLES


def test_chain_and_median_time_on_the_cpu():
    x = torch.rand(4096)
    calls = []

    def make(k):
        def run():
            for _ in range(k):
                calls.append((x * 2).sum())
        return run
    per_op = timing.chain_time(make, k=5, reps=3, device="cpu")
    assert math.isfinite(per_op) and per_op > 0
    assert len(calls) == 5 * 4          # a warm-up and three timed runs
    t = timing.median_time(lambda: float(x.sum()), reps=3)
    assert math.isfinite(t) and t > 0
    t = timing.call_time(lambda: x * 3, "cpu", k=4, reps=3)
    assert math.isfinite(t) and t > 0


def test_wall_time_counts_every_call_and_the_host_wait():
    """wall_time: one warm-up, then reps windows of k calls; a call that
    waits on the host (here a sleep) is in its time."""
    calls = []

    def step():
        calls.append(None)
        time.sleep(0.002)
    t = timing.wall_time(step, "cpu", k=3, reps=3)
    assert len(calls) == 1 + 3 * 3
    assert 0.002 <= t < 1.0


def test_roofline_report_has_the_reference_header():
    entries = [("mvm 4x4", 67_108_864, 2e-5), ("restore", 1 << 20, 1e-4)]
    got = profile.roofline_report(entries, H100).splitlines()
    want = jax_profile.roofline_report(entries).splitlines()
    assert got[0] == want[0]
    assert len(got) == 3
    assert got[1].startswith("mvm 4x4") and got[1].endswith("%")
    assert f"{100.0 * 67_108_864 / 2e-5 / 3.35e12:>9.1f}%" in got[1]


def test_trace_and_annotate_on_the_cpu(tmp_path):
    with profile.trace(str(tmp_path)) as prof:
        with profile.annotate("probe region"):
            torch.rand(256, 256).sum()
    assert any(e.key == "probe region" for e in prof.key_averages())
    assert list(tmp_path.glob("trace-*.json"))
