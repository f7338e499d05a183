"""Running the port's examples (``examples_torch/``) in the tests: each in
process through its ``main(argv)`` with ``--device cpu`` at
``tests/test_examples.py``'s reduced flags (``chip_smoke.EX_FLAGS``, the
flags the smoke's ``examples`` phase runs them at on the card), in a
working directory of the test's own."""

import contextlib
import importlib.util
import io
import os
from pathlib import Path

import torch

from chip_smoke import EX_FLAGS, EX_KEYWORDS

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples_torch"
NAMES = sorted(p.stem for p in EXAMPLES.glob("[0-9][0-9]_*.py"))


def load_example(name: str):
    """The example ``name`` (e.g. ``"06_fast_inference"``) as a module."""
    spec = importlib.util.spec_from_file_location(
        "example_" + name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, cwd: Path, *extra, **kw) -> str:
    """Run ``name``'s ``main`` on the CPU at its reduced flags (plus
    ``extra``) in ``cwd``; assert it returned 0 and printed one of the
    words ``tests/test_examples.py`` looks for. Returns its output."""
    argv = ["--device", "cpu", *EX_FLAGS.get(name, []), *extra]
    out = io.StringIO()
    prev = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = load_example(name).main(argv, **kw)
    finally:
        os.chdir(prev)
    text = out.getvalue()
    assert rc == 0, text[-2000:]
    assert any(k in text for k in EX_KEYWORDS), text[-2000:]
    return text


@contextlib.contextmanager
def torch_threads(n: int):
    """Pin torch's intra-op thread count for the block."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
