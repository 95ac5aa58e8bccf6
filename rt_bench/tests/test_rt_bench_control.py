"""Each control, the plain reference in the program's place computed in
bfloat16 (the precision below the configurations' float32), all of it or
its colour alone, comes out as not correct under every cell's limit; here
at a small size on the CPU (``rt_bench/control.py`` reads them on the card
at the cells' own size)."""

import pytest
import torch

from rt_bench import control, harness
from rt_bench.reference import compare
from rt_bench.tests.common import CELLS, ROOT, SEED, small


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    config, mix = small(cell)
    spec = harness.generate(config)
    frames = 4
    pix = harness.sample_pixels(SEED, mix["width"], mix["height"], frames,
                                mix["spp"])
    found = control.control_numbers(spec, config, mix, SEED, spec.camera,
                                    pix, frames, torch.device("cpu"))
    assert set(found) == set(control.CONTROLS)
    for name, value in found.items():
        correct, rows = compare.judge({"rel_l1": value},
                                      compare.limits(ROOT, cell))
        assert not correct, (name, rows)
