"""The port's tuned IHT tables are clover_tpu's, entry for entry."""

import pytest

from clover_tpu.models import tuned as jax_tuned
from clover_tpu_torch.models import tuned

TABLES = ["IHT_4BIT", "IHT_MIXED_4X8", "IHT_PURE_FAMILY", "IHT_MIXED_FAMILY"]


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_reference(name):
    assert getattr(tuned, name) == getattr(jax_tuned, name)


def test_main_path_entries():
    """The 8192x16384 entries the chip check's solves read."""
    key = (8192, 16384)
    assert tuned.IHT_4BIT[key]["mu"] == 0.0002138596817016602
    assert tuned.IHT_4BIT[key]["iters"] == 2
    assert tuned.IHT_MIXED_4X8[key]["mu"] == 0.00015654396991729737
    assert tuned.IHT_MIXED_4X8[key]["iters"] == 1
    assert tuned.IHT_PURE_FAMILY[key][8] == (1, 0.0001114352649688721)
    for name in TABLES:
        assert getattr(tuned, name)[key] == getattr(jax_tuned, name)[key]
