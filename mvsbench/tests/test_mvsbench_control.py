"""The control fails the limits: the reference computed with TF32 on, put
in the program's place, reads above a limit of each cell (on the card:
the CPU has no TF32), while the program on the same seed stays within
them. At the cells' own sizes, one checked map a cell (~1.5 min for the
three); `python3 -m mvsbench.control` reads more seeds (PERF.md gives its
readings)."""

import pytest
import torch

from mvsbench import core

SMALL = {
    "adamvs.fullres": {"traffic": {"check_maps": 1}},
    "msrednet.fullres": {"traffic": {"check_maps": 1}},
    "adamvs.train_whu": {},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    res, readings = core.run(cell, 2 ** 31 + 99, 1.0, False, overrides=SMALL[cell], control=True)
    limits = core.load("limits", cell)
    assert res["correct"], res["checks"]
    assert any(readings[f"control.{k}"] > lim for k, lim in limits.items()), readings
