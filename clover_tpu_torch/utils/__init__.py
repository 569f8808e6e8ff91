"""Debug utilities (counterpart of clover_tpu/utils): array printers and
the side-by-side diff the validation mode dumps for every failed check."""

from .debug import compare, format_blocks, format_qvec  # noqa: F401
