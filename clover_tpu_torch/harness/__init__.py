"""The command-line modes' harness (counterpart of clover_tpu/harness/):
``validate`` (``-v``), ``accuracy`` (``-a``) and the system banner.  Entry
point: clover_tpu_torch.cli."""

from . import accuracy, sysinfo, validate  # noqa: F401
