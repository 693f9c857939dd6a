"""The port's shape tables (``repro_torch.configs.shapes``) are copies of
``repro.configs.shapes``: every entry equal, field by field."""
import dataclasses

import pytest

from repro import configs as j_configs
from repro_torch import configs


@pytest.mark.parametrize("table", ["SHAPES", "SMOKE_SHAPES"])
def test_shape_tables_are_repros(table):
    got, want = getattr(configs, table), getattr(j_configs, table)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])


@pytest.mark.parametrize("smoke", [False, True])
def test_get_shape_resolves_as_repros(smoke):
    for name in j_configs.SHAPES:
        assert dataclasses.asdict(configs.get_shape(name, smoke)) == \
            dataclasses.asdict(j_configs.get_shape(name, smoke))
    with pytest.raises(KeyError):
        configs.get_shape("prefill_1m")
