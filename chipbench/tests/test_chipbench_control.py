"""The control, on the card: the reference put in the program's place in
TF32 (the precision below the configurations' float32 with TF32 off)
fails a cell's check where the program passes it, at a size a test run
holds. Run on the card: `python -m pytest -q chipbench/tests`."""
from __future__ import annotations

import pytest

from chipbench import bench
from chipbench.drivers import train
from chipbench.tests.conftest import tiny


@pytest.mark.card
@pytest.mark.parametrize("name", ["train-tgl-pres-b2400",
                                  "train-tgl-std-b600"])
def test_control_fails_where_the_program_passes(card, name):
    cell = tiny(name)
    for seed in (11, 12, 13):
        got = train.calibrate(cell, seed, card)
        assert bench.judge(got["program"], cell.limits)[0], got
        assert not bench.judge(got["control"], cell.limits)[0], got
