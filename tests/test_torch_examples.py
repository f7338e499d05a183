"""The port's examples (``examples_torch/01``-``21``) on the CPU, part 1:
the layout, the flags, the device rule, and examples 01-10 run in process
at ``tests/test_examples.py``'s reduced flags, each holding its own
asserts (JAX's thresholds). The rasterising examples (12-15) have files
of their own, 11 and 16-21 are in ``test_torch_examples_more.py``, the
parity with the JAX functions in ``test_torch_examples_parity*.py``."""

import ast
import os
import subprocess
import sys

import pytest

from torch_examples_run import (
    EXAMPLES, NAMES, ROOT, load_example, run_example, torch_threads,
)

JAX_EXAMPLES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small fits of many small ops: one intra-op thread each, so parallel
    test workers do not oversubscribe the cores."""
    with torch_threads(1):
        yield


def test_one_port_example_per_jax_example():
    assert NAMES == JAX_EXAMPLES and len(NAMES) == 21
    readme = (EXAMPLES / "README.md").read_text()
    for name in NAMES:
        assert f"`{name}.py`" in readme, name


def _reduced_flags_of_test_examples() -> dict:
    """The ``{stem: [flags]}`` literal of ``tests/test_examples.py``."""
    tree = ast.parse((ROOT / "tests" / "test_examples.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and str(k.value)[:2].isdigit()
                for k in node.keys):
            return ast.literal_eval(node)
    raise AssertionError("no flags dict in tests/test_examples.py")


def test_reduced_flags_are_test_examples_flags():
    from chip_smoke import EX_FIGURES, EX_FLAGS

    assert EX_FLAGS == _reduced_flags_of_test_examples()
    assert set(EX_FIGURES) == set(NAMES) - {"01_quickstart"}


@pytest.mark.parametrize("name", NAMES)
def test_every_flag_but_the_device_is_jax_s(name):
    """``--device`` replaces ``--platform``; every other flag keeps its
    name and default (09's artifact name aside: ``.torchexp``)."""
    def flags(path):
        tree = ast.parse(path.read_text())
        got = {}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "add_argument"):
                default = next((ast.literal_eval(k.value)
                                for k in node.keywords if k.arg == "default"),
                               None)
                got[node.args[0].value] = default
        return got

    jax_flags = flags(ROOT / "examples" / f"{name}.py")
    port = flags(EXAMPLES / f"{name}.py")
    assert jax_flags.pop("--platform") == ""
    if name == "09_aot_serving":
        assert jax_flags.pop("--out") == "mano_fwd.jaxexp"
        assert port.pop("--out") == "mano_fwd.torchexp"
    assert port == jax_flags


@pytest.mark.parametrize("name", NAMES)
def test_no_card_and_no_device_flag_raises_naming_the_flag(name,
                                                           monkeypatch):
    """The examples run on the card by default and never fall back to the
    CPU on their own."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        load_example(name).main([])


def test_an_example_runs_standalone(tmp_path):
    """As a user runs it: a fresh interpreter, the script's own path."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "01_quickstart.py"), "--device",
         "cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "device cpu" in proc.stdout and "wrote" in proc.stdout
    assert (tmp_path / "quickstart_hand.obj").exists()
    assert (tmp_path / "quickstart_hand_restpose.obj").exists()


@pytest.mark.parametrize("name", [n for n in NAMES if n[:2] <= "10"])
def test_example_runs(name, tmp_path):
    run_example(name, tmp_path)
