"""The control on the card: the reference in TF32, the nearest precision
below the configurations' IEEE fp32, put in the program's place, must
come out not correct; the program itself correct on the same seeds.
At a size a test run holds, each cell's ``control`` size from
``sizes/`` (the cells' own size is run by ``benchmark/calibrate.py``)."""

import time

import pytest

from benchmark import harness
from benchmark.tests.small import sizes

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def run(cell, card, seed, control):
    return harness.run_cell(
        cell, seed, 0.5, False, card, time.perf_counter(),
        wrap=(lambda e: e.control()) if control else None,
        overrides=sizes(cell, control=True))


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, seed, card):
    assert run(cell, card, seed, control=False)["correct"] is True
    assert run(cell, card, seed, control=True)["correct"] is False
