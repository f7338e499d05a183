"""The tests' sizes, as data: ``sizes/<mix>.json`` for each traffic mix,
or ``sizes/<cell>.json``, which takes its mix's file's place for that one
cell (a configuration too wide for the mix's CPU size would bring its
own; no cell has one yet). Each file holds ``small``, the CPU size (a
cell's paths and checks at a size a test run holds), and ``control``,
laid over ``small`` on the card by ``test_hb_control.py``. ``SMALL`` and
``CONTROL`` are keyed by the file's name."""

import json
from pathlib import Path

import pytest

from benchmark import harness

SIZES = Path(__file__).resolve().parent / "sizes"
_FILES = {p.stem: json.loads(p.read_text())
          for p in sorted(SIZES.glob("*.json"))}
SMALL = {name: f["small"] for name, f in _FILES.items() if "small" in f}
CONTROL = {name: f["control"] for name, f in _FILES.items()
           if "control" in f}


def sizes_name(cell: dict):
    """The name of the sizes file ``cell`` (a ``workloads`` entry) takes:
    its own, else its mix's; None where neither holds both sizes."""
    for name in (cell["name"], cell["traffic"]):
        if name in SMALL or name in CONTROL:
            return name if name in SMALL and name in CONTROL else None
    return None


def missing(cell: dict) -> str:
    return (f"add benchmark/tests/sizes/{cell['traffic']}.json (or "
            f"{cell['name']}.json for this cell alone) holding 'small' and "
            f"'control' sizes")


def sizes(cell_name: str, control: bool = False) -> dict:
    """The sizes a test runs the cell at: ``small``, with ``control``
    laid over it on the card. A cell without its file fails the test
    that asks, naming the file to add."""
    cell = harness.find_cell(harness.load_spec(), cell_name)
    name = sizes_name(cell)
    if name is None:
        pytest.fail(missing(cell))
    return dict(SMALL[name], **(CONTROL[name] if control else {}))
