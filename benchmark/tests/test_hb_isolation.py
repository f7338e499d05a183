"""Nothing the benchmark runs imports the JAX stack or the JAX package,
compared by whole top-level name (the port's name starts with the JAX
package's); the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_stack_or_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mano_hand_tpu_torch" not in top_level_imports(path)


def test_the_run_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "mano_hand_tpu_torch_x",
                        types.ModuleType("mano_hand_tpu_torch_x"))
    assert "mano_hand_tpu_torch_x" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "mano_hand_tpu.models",
                        types.ModuleType("mano_hand_tpu.models"))
    assert "mano_hand_tpu" in harness.forbidden_loaded()
