"""``benchmark/work.py`` counts what ``chip_smoke.py``'s ``k1_work`` and
``k2_work`` count, at the cells' shapes (the smoke's functions are read
from its source, not imported)."""

import ast
from pathlib import Path

import pytest

from benchmark import work

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def smoke_functions():
    tree = ast.parse(SMOKE.read_text())
    wanted = [n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name in ("k1_work", "k2_work")]
    scope = {}
    exec(compile(ast.Module(body=wanted, type_ignores=[]), str(SMOKE),
                 "exec"), scope)
    return scope["k1_work"], scope["k2_work"]


@pytest.mark.parametrize("b", [1, 8192, 32768, 65536, 16384])
def test_forward_work_is_k1_work(b):
    k1_work, _ = smoke_functions()
    assert work.forward_work(b, 778, 16, 10) == k1_work(b, 778, 16, 10)


@pytest.mark.parametrize("b,used", [(1024, 64), (65536, 1000), (65536, 731)])
def test_posed_work_is_k2_work(b, used):
    _, k2_work = smoke_functions()
    assert work.posed_work(b, used, 778, 16) == k2_work(b, used, 778, 16)


def test_bound_and_peaks():
    flops, moved = work.forward_work(65536, 778, 16, 10)
    t = work.bound_s(flops, moved, "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(flops / 67e12)          # operations bound it
    assert t == pytest.approx(0.9726e-3, rel=1e-3)
    with pytest.raises(ValueError):
        work.peaks("NVIDIA A100-SXM4-80GB")
