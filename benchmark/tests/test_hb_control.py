"""The control on the card: the reference in TF32, the nearest precision
below the configurations' IEEE fp32, put in the program's place, must
come out not correct; the program itself correct on the same seeds.
At a size a test run holds (the cells' own size is run by
``benchmark/calibrate.py``)."""

import time

import pytest

from benchmark import harness
from benchmark.tests.small import SMALL

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SIZE = {
    "bulk_forward": dict(rows=8192, chunk_size=4096),
    "bulk_forward_hands": dict(rows_per_hand=4096),
    "posed_gather": dict(rows=8192),
}


def run(cell, card, seed, control):
    traffic = harness.find_cell(harness.load_spec(), cell)["traffic"]
    over = dict(SMALL[traffic], **SIZE[traffic])
    return harness.run_cell(
        cell, seed, 0.5, False, card, time.perf_counter(),
        wrap=(lambda e: e.control()) if control else None, overrides=over)


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, seed, card):
    assert run(cell, card, seed, control=False)["correct"] is True
    assert run(cell, card, seed, control=True)["correct"] is False
