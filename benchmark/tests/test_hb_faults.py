"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: ``correct`` must come out false for each
fault the cell can have, and true for the sound program."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import sizes

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
BULK = [w["name"] for w in harness.load_spec()["workloads"]]


def run(cell, wrap=None):
    return harness.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter(),
                            wrap=wrap, overrides=sizes(cell))


def broken(fault):
    def wrap(entry):
        sound = entry.call

        def call(slot):
            return fault(sound(slot), entry, slot)
        entry.call = call
    return wrap


def alter_one(out, entry, slot):
    out = out.clone()
    out.reshape(-1, *out.shape[-2:])[3, 100, 1] += 1e-3
    return out


def drop_half(out, entry, slot):
    flat = out.reshape(-1, *out.shape[-2:])
    return flat[: flat.shape[0] // 2]


def zero_half(out, entry, slot):
    out = out.clone()
    flat = out.reshape(-1, *out.shape[-2:])
    flat[flat.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize("cell", BULK)
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", [alter_one, drop_half, zero_half],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", BULK)
def test_bulk_fault_is_caught(cell, fault):
    line = run(cell, broken(fault))
    assert line["correct"] is False, line["checks"]
