"""The command-line modes' harness (counterpart of clover_tpu/harness/):
``validate`` (``-v``), ``perf`` (``-p``) on the ``timing`` protocol,
``accuracy`` (``-a``), ``search`` (``-g``), ``profile`` (device traces and
the roofline table) and the system banner.  Entry point:
clover_tpu_torch.cli."""

from . import (  # noqa: F401
    accuracy, perf, profile, search, sysinfo, timing, validate,
)
