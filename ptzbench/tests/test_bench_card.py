"""On the card: the control (the reference with TF32 on, in the program's
place) fails the committed limits of a cell, and a short run of the cell
passes them. Run on the card with

    python -m pytest ptzbench/tests/test_bench_card.py -q -p no:cacheprovider
"""

from __future__ import annotations

import time

import pytest

from ptzbench import run
from ptzbench.registry import Registry

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["redetect720.steady"])
def test_control_fails_and_program_passes(cuda_device, cell):
    reg = Registry(run.ROOT)
    c = reg.cell(cell)
    res, lines = run.run_cell(reg, c, 2**31 + 123, 2.0, False, cuda_device, t_import=time.perf_counter(), control=True)
    assert res["correct"], lines
    from ptzbench import check

    assert not check.verdict(res["control"], c.limits)[0], res["control"]
