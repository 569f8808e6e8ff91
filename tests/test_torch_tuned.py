"""The port's tuned IHT and GD tables are clover_tpu's, entry for entry,
and so are their lookups."""

import pytest

from clover_tpu.models import tuned as jax_tuned
from clover_tpu_torch.models import tuned

IHT_TABLES = ["IHT_4BIT", "IHT_MIXED_4X8", "IHT_PURE_FAMILY",
              "IHT_MIXED_FAMILY"]
TABLES = IHT_TABLES + ["GD_4BIT", "GD_MIXED_4X8", "GD_PURE_FAMILY",
                       "GD_MIXED_FAMILY"]
KINDS = ["iht", "iht_mixed", "gd", "gd_mixed"]


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
    for name in IHT_TABLES:
        assert getattr(tuned, name)[key] == getattr(jax_tuned, name)[key]


@pytest.mark.parametrize("kind", KINDS)
def test_lookups_equal_the_reference_on_every_key(kind):
    keys = set()
    for name in TABLES:
        keys |= set(getattr(jax_tuned, name))
    keys.add((123, 456))                    # absent everywhere: None
    for m, n in sorted(keys):
        assert tuned.lookup(kind, m, n) == jax_tuned.lookup(kind, m, n)
        assert tuned.lookup_family(kind, m, n) == \
            jax_tuned.lookup_family(kind, m, n)
        for bits in (4, 8, 16, 32, 2):
            assert tuned.lookup_family(kind, m, n, bits) == \
                jax_tuned.lookup_family(kind, m, n, bits)
