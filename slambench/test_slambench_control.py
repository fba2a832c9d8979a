"""The correctness control at a size a test run holds (CPU, tiny): the
reference with its float32 products rounded to TF32, put in the
program's place, fails the cell's limits, while the program passes them
(``slambench/control.py`` takes the same readings on the card at the
cell's own size)."""
from __future__ import annotations

import pytest
import torch

from slambench import tiny
from slambench.harness.compare import judge
from slambench.harness.control import round_tf32


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265], dtype=torch.float32)
    got = round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                      # a tie goes to even
    assert got[3] == 1.0 + 2 ** -9            # a tie goes to even
    assert abs(float(got[4]) + 3.14159265) < 2 ** -9


@pytest.mark.parametrize("cell", ["desk-live30", "fleet8-recorded",
                                  "desk-chunk8-vo"])
def test_the_control_fails_where_the_program_passes(cell):
    ctx = tiny.context(cell, seed=9, control=True)
    ok, res = tiny.run(ctx)
    assert ok, res.numbers
    limits = ctx.cell.traffic["check"]["limits"]
    assert not judge(res.control_numbers, limits)[0], res.control_numbers
